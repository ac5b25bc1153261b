"""Serving export on the CPU: ``TTSEngine.export`` writes ``torch.export``
artifacts of FastSpeech 2 that load and run.

Small engines (tests/torch_port_pair.export_engine: d 32, 2+2 layers, one
bucket of 8 phones) of the transformer FastSpeech 2, with x-vectors and
hop sizes, and with int8 weights: each bucket's artifact, saved, loaded
and called, gives the engine's ``_run_padded`` outputs bit for bit, and
the manifest has the JAX engine's keys. The vocoder artifact gives
``vocode_pinned``'s samples bit for bit. At 256 frames the artifact's
decoder runs through the ``tts_port::flash_fwd`` op and still equals the
engine. The AR artifacts are tests/test_torch_port_export_ar.py; the JAX
artifacts and ``cli/serve.py --export`` tests/test_torch_port_export_jax.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from transformer_tts_tpu_torch.infer.streaming import vocode_pinned

from torch_port_pair import (
    engine_pair, export_engine, export_inputs, load_artifact,
    write_tiny_vocoder)


@pytest.fixture(scope="module")
def transformer_dir(tmp_path_factory):
    """The transformer FastSpeech 2's port checkpoint, written once."""
    return engine_pair("transformer", tmp_path_factory.mktemp("pair"))[1]


@pytest.mark.parametrize("family", ["transformer", "xvector", "int8"])
def test_bucket_artifacts_equal_the_engine(family, tmp_path,
                                           transformer_dir):
    engine = export_engine(family, tmp_path, None if family == "xvector"
                           else transformer_dir)
    out_dir = str(tmp_path / "exported")
    manifest = engine.export(out_dir)
    stem = "transformer_tts" if family in ("ar", "gst") else "fastspeech2"
    assert manifest["buckets"]["8"] == {
        "file": f"{stem}_b2_l8.pt2", "max_frames": engine.max_frames_for(8),
        "platforms": ["cpu"]}
    assert manifest["speaker_input"] == ("x_vector" if family == "xvector"
                                         else None)
    with open(os.path.join(out_dir, "manifest.json")) as fh:
        assert json.load(fh) == manifest
    inputs = export_inputs(engine, 8)
    with torch.no_grad():
        got = load_artifact(out_dir, manifest["buckets"]["8"])(*inputs)
        want = [x for x in engine._run_padded(*inputs) if x is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_vocoder_artifact_equals_vocode_pinned(tmp_path, transformer_dir):
    voc = write_tiny_vocoder(tmp_path / "voc")
    engine = export_engine("transformer", tmp_path, transformer_dir,
                           vocoder=voc)
    out_dir = str(tmp_path / "exported")
    manifest = engine.export(out_dir)
    vocoder = manifest["vocoder"]
    assert vocoder["hop_length"] == engine._vocoder.hop_length
    assert vocoder["allow_tf32"] is False
    (budget, entry), = vocoder["budgets"].items()
    assert entry == {"file": f"vocoder_b2_f{budget}.pt2",
                     "platforms": ["cpu"]}
    mel = torch.as_tensor(np.random.RandomState(1).randn(
        2, int(budget), engine.hp.mel_dim).astype(np.float32))
    with torch.no_grad():
        got = load_artifact(out_dir, entry)(mel)
    assert torch.equal(got, vocode_pinned(engine._vocoder, mel))


def test_the_artifact_runs_the_kernel_op_at_256_frames(tmp_path,
                                                       transformer_dir):
    engine = export_engine("transformer", tmp_path, transformer_dir,
                           frames_per_phone=32)
    assert engine.max_frames_for(8) == 256
    out_dir = str(tmp_path / "exported")
    manifest = engine.export(out_dir)
    program = torch.export.load(os.path.join(
        out_dir, manifest["buckets"]["8"]["file"]))
    # the ops of the graph and of its autocast regions' subgraphs
    ops = [str(n.target) for gm in program.graph_module.modules()
           if isinstance(gm, torch.fx.GraphModule)
           for n in gm.graph.nodes if n.op == "call_function"]
    assert ops.count("tts_port.flash_fwd.default") == 2  # decoder layers
    inputs = export_inputs(engine, 8)
    with torch.no_grad():
        got = program.module()(*inputs)
        want = engine._run_padded(*inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
