"""Serving export of the AR Transformer-TTS on the CPU.

The AR and GST engines' artifacts (tests/torch_port_pair.export_engine),
whose decode is one ``torch.while_loop``, give the engine's
``_run_padded`` outputs bit for bit: the loop stops at the last row's
stop, where the engine's eager loop runs to the end of that block of 8
steps, which changes no output. ``ar_decode_loop`` equals the eager loop
``ar_decode``, lengths and every step it ran included.
"""

import json
import os

import pytest
import torch

from transformer_tts_tpu_torch.infer import synthesize as synth
from transformer_tts_tpu_torch.ops.masks import pad_mask

from torch_port_pair import (
    AR_STOP_BIAS, ENGINE_TEXTS, build_ar_pair, export_engine, export_inputs,
    load_artifact, set_stop_bias)


@pytest.mark.parametrize("family", ["ar", "gst"])
def test_ar_bucket_artifacts_equal_the_engine(family, tmp_path):
    engine = export_engine(family, tmp_path)
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


def test_while_loop_decode_equals_the_eager_loop():
    _, _, variables, model = build_ar_pair(0)
    set_stop_bias(variables, model, AR_STOP_BIAS)
    text = torch.zeros(2, 16, dtype=torch.long)
    for row, ids in enumerate((ENGINE_TEXTS[2], ENGINE_TEXTS[4])):
        text[row, :len(ids)] = torch.tensor(ids)
    pos = (text > 0).long() * torch.arange(1, 17)
    max_steps = 40
    with torch.no_grad():
        src_mask = pad_mask(pos)
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        eager = synth.ar_decode(model, e_outputs, src_mask, cross, max_steps,
                                0.5)
        looped = synth.ar_decode_loop(model, e_outputs, src_mask, cross,
                                      max_steps, 0.5)
    assert torch.equal(looped["length"], eager["length"])
    assert torch.equal(looped["done"], eager["done"])
    steps = int(looped["step"])
    # JAX's stop: the loop ends at the last row's stop, the eager loop at
    # the end of that block of DONE_CHECK_EVERY steps
    assert looped["length"].tolist() == [25, 5] and steps == 25
    assert int(eager["step"]) == 32
    assert torch.equal(looped["groups"][:, :steps], eager["groups"][:, :steps])
    assert not looped["groups"][:, steps:].any()
    for (lk, lv), (ek, ev) in zip(looped["caches"], eager["caches"]):
        assert torch.equal(lk[:, :, :steps], ek[:, :, :steps])
        assert torch.equal(lv[:, :, :steps], ev[:, :, :steps])
