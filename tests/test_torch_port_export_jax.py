"""Serving export against the JAX package's, and ``cli/serve.py
--export``, on the CPU.

The same weights carried from flax (tests/torch_port_pair.engine_pair)
give artifact outputs within the JAX package's own tolerance of its
artifacts' ``.call``: the mel within 1e-5 of max(1, max|ref|), the
tolerance of tests/test_serving.py, for the AR model too (its rows
stopping at different steps); lengths and durations exactly. The CLI writes
the artifacts and prints the manifest, and a loader in a fresh process
that imports only torch and the two ops modules runs the artifact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from transformer_tts_tpu.infer.engine import TTSEngine as JaxTTSEngine
from transformer_tts_tpu_torch.cli import serve as serve_cli
from transformer_tts_tpu_torch.infer.engine import TTSEngine

from torch_port_pair import (
    ENGINE, ENGINE_TEXTS, EXPORT_ENGINE, engine_pair, export_inputs,
    load_artifact)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOADER = """
import sys
import numpy as np
import torch
import transformer_tts_tpu_torch.ops.flash_attention
import transformer_tts_tpu_torch.ops.flash_relpos
program = torch.export.load(sys.argv[1]).module()
inputs = [torch.from_numpy(x) for x in np.load(sys.argv[2]).values()]
with torch.no_grad():
    out = program(*inputs)
out = out if isinstance(out, (tuple, list)) else (out,)
np.savez(sys.argv[3], *[o.numpy() for o in out])
"""


@pytest.mark.parametrize("family", ["transformer", "ar"])
def test_artifacts_match_the_jax_artifacts(family, tmp_path):
    from jax import export as jexport
    # the AR rows stop at different steps inside bucket 16's budget
    bucket, texts = ((16, [ENGINE_TEXTS[2], ENGINE_TEXTS[4]])
                     if family == "ar" else (8, ENGINE_TEXTS[:2]))
    kw = dict(ENGINE, text_buckets=(bucket,))
    jax_dir, port_dir, _ = engine_pair(family, tmp_path)
    jax_manifest = JaxTTSEngine(jax_dir, **kw).export(str(tmp_path / "jax"))
    engine = TTSEngine(port_dir, **kw, device="cpu")
    manifest = engine.export(str(tmp_path / "port"))
    assert set(manifest) == set(jax_manifest)
    assert ({k: v["max_frames"] for k, v in manifest["buckets"].items()}
            == {k: v["max_frames"]
                for k, v in jax_manifest["buckets"].items()})
    key = str(bucket)
    with open(tmp_path / "jax" / jax_manifest["buckets"][key]["file"],
              "rb") as fh:
        jax_program = jexport.deserialize(fh.read())
    text, pos = export_inputs(engine, bucket, texts)
    ref = [np.asarray(x) for x in jax_program.call(
        text.numpy().astype(np.int32), pos.numpy().astype(np.int32))]
    with torch.no_grad():
        got = [x.numpy() for x in load_artifact(str(tmp_path / "port"),
                                        manifest["buckets"][key])(text, pos)]
    assert len(got) == len(ref)
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref[0]).max()))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g, r)
    if family == "ar":
        assert got[1].tolist() == [50, 10]


def test_serve_cli_export_and_a_bare_loader(tmp_path, capsys):
    _, port_dir, _ = engine_pair("transformer", tmp_path)
    out_dir = tmp_path / "exported"
    assert serve_cli.main(["--load_name", port_dir, "--export", str(out_dir),
                           "--batch_size", "2", "--buckets", "8",
                           "--frames_per_phone", "4", "--device",
                           "cpu"]) is None
    manifest = json.loads(capsys.readouterr().out)
    with open(out_dir / "manifest.json") as fh:
        assert json.load(fh) == manifest
    entry = manifest["buckets"]["8"]
    assert os.path.exists(out_dir / entry["file"])
    engine = TTSEngine(port_dir, **EXPORT_ENGINE, device="cpu")
    inputs = export_inputs(engine, 8)
    np.savez(tmp_path / "in.npz", *[x.numpy() for x in inputs])
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", LOADER,
                    str(out_dir / entry["file"]), str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    got = np.load(tmp_path / "out.npz")
    with torch.no_grad():
        want = engine._run_padded(*inputs)
    for g, w in zip(got.values(), want):
        np.testing.assert_array_equal(g, w.numpy())
