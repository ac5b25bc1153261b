"""The AR decode loop of the port, on the CPU: its in-place step and the
block schedule that the CUDA graph replays.

``_ar_body`` writes every carry update into the carry's own tensors, so a
captured step reads and writes fixed addresses; here it gives the same mel
and lengths, bit for bit, as the step that rebound its carry to new
tensors (kept below as the reference), on the AR pair of
tests/torch_port_pair.py. ``_run_blocks`` runs the steps in blocks of
``DONE_CHECK_EVERY`` with a shorter tail, checking ``done`` between
blocks; it must run exactly the steps of the loop that checked every
``DONE_CHECK_EVERY`` steps. The graph itself runs on the card only
(chip_smoke.py holds it bit for bit against the eager loop there).
"""

import numpy as np
import pytest
import torch

from test_torch_port_ar import _forced_threshold, _stop_probs, _text
from torch_port_pair import build_ar_pair
from transformer_tts_tpu_torch.infer import synthesize as synth
from transformer_tts_tpu_torch.ops.masks import pad_mask


@pytest.fixture(scope="module")
def model():
    return build_ar_pair()[3]


def _rebinding_body(model, e_outputs, src_mask, cross_kvs, threshold):
    """The decode step as it was before it wrote in place: each update a
    new tensor bound into the carry."""
    def body(c):
        step = c["step"]
        group, stop = model.decode_step(c["prev"], e_outputs, src_mask,
                                        c["caches"], step, cross_kvs)
        c["groups"].index_copy_(1, step.reshape(1), group.float())
        p_stop = torch.sigmoid(stop.float())[:, 0]
        stop_now = p_stop.mean(dim=-1) > threshold
        newly_done = stop_now & ~c["done"]
        c["length"] = torch.where(newly_done, step + 1, c["length"])
        c["done"] = c["done"] | stop_now
        c["prev"] = group[:, :, :model.mel_dim].to(c["prev"].dtype)
        c["step"] = step + 1
        return c
    return body


def _old_synthesis(model, text, pos_text, max_steps, threshold):
    """(groups, lengths) of the loop that checked ``done`` every
    ``DONE_CHECK_EVERY`` steps with the rebinding step."""
    src_mask = pad_mask(pos_text)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        carry = synth._ar_init(model, text.shape[0], max_steps, "cpu")
        body = _rebinding_body(model, e_outputs, src_mask, cross, threshold)
        for step in range(max_steps):
            if (step and step % synth.DONE_CHECK_EVERY == 0
                    and bool(carry["done"].all())):
                break
            carry = body(carry)
    return carry["groups"], carry["length"]


@pytest.mark.parametrize("stops", [False, True])
def test_in_place_step_gives_the_previous_mel_and_lengths(model, stops):
    steps = 12
    text, pos_text = (torch.as_tensor(x) for x in _text(12))
    text = text.long()
    threshold = (_forced_threshold(_stop_probs(model, text, pos_text, steps))
                 if stops else 2.0)
    groups, lengths = _old_synthesis(model, text, pos_text, steps, threshold)
    src_mask = pad_mask(pos_text)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        carry = synth.ar_decode(model, e_outputs, src_mask,
                                model.precompute_cross_kv(e_outputs), steps,
                                threshold)
    assert torch.equal(carry["groups"], groups)
    assert torch.equal(carry["length"], lengths)
    assert bool((lengths < steps).any()) == stops
    mel, mel_len = synth.synthesize_transformer_tts(
        model, text, pos_text, max_steps=steps, stop_threshold=threshold)
    assert torch.equal(mel_len, lengths * model.reduction_rate)
    with torch.inference_mode():
        post = model.apply_postnet(groups).reshape(2, -1, model.mel_dim)
    for row, n in enumerate(mel_len.tolist()):
        assert torch.equal(mel[row, :n], post[row, :n])
        assert not mel[row, n:].any()


def test_every_carry_update_keeps_its_storage(model):
    text, pos_text = (torch.as_tensor(x) for x in _text(3))
    src_mask = pad_mask(pos_text)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text.long(), src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        carry = synth._ar_init(model, 2, 6, "cpu")
        addresses = {k: v.data_ptr() for k, v in carry.items()
                     if torch.is_tensor(v)}
        body = synth._ar_body(model, e_outputs, src_mask, cross, 0.5)
        for _ in range(4):
            body(carry)
        assert {k: carry[k].data_ptr() for k in addresses} == addresses
        assert int(carry["step"]) == 4
        synth._ar_reset(carry, 6)
        fresh = synth._ar_init(model, 2, 6, "cpu")
    for key in ("step", "prev", "groups", "done", "length"):
        assert torch.equal(carry[key], fresh[key])
    assert not any(c.any() for kv in carry["caches"] for c in kv)


@pytest.mark.parametrize("max_steps", [1, 5, 8, 12, 17, 500])
@pytest.mark.parametrize("every", [1, 8])
def test_blocks_run_the_steps_of_the_checked_loop(monkeypatch, max_steps,
                                                  every):
    monkeypatch.setattr(synth, "DONE_CHECK_EVERY", every)
    for all_done_at in (1, 3, 8, 9, 16, 40, 499, None):
        # the loop of one check every DONE_CHECK_EVERY steps
        done_at = all_done_at or 10 ** 9
        want = 0
        for step in range(max_steps):
            if step and step % every == 0 and step >= done_at:
                break
            want += 1
        ran, blocks = [0], []
        done = torch.zeros(1, dtype=torch.bool)

        def run_block(n):
            blocks.append(n)
            ran[0] += n
            done.fill_(ran[0] >= done_at)

        synth._run_blocks(run_block, done, max_steps)
        assert ran[0] == want
        assert all(n == every for n in blocks[:-1])
        assert {n for n in blocks} <= {min(every, max_steps),
                                       max_steps % every or every}


def test_graphed_decode_takes_cuda_tensors_only(model):
    text, pos_text = (torch.as_tensor(x) for x in _text(4))
    src_mask = pad_mask(pos_text)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text.long(), src_mask)
        with pytest.raises(ValueError, match="CUDA"):
            synth.ar_decode_graphed(model, e_outputs, src_mask,
                                    model.precompute_cross_kv(e_outputs), 8,
                                    0.5)


def test_autocast_keeps_its_weight_cache_outside_a_capture(model):
    x = torch.zeros(1)
    model.amp = True
    try:
        with model._autocast(x):
            assert torch.is_autocast_cache_enabled()
    finally:
        model.amp = False
    assert np.isfinite(float(x.sum()))


def _amp_decode(model, text, pos_text, steps, weights=None):
    src_mask = pad_mask(pos_text)
    e_outputs, _ = model.encode(text, src_mask)
    cross = model.precompute_cross_kv(e_outputs)
    if weights is None:
        return synth.ar_decode(model, e_outputs, src_mask, cross, steps, 2.0)
    with weights.swapped_in():
        return synth.ar_decode(model, e_outputs, src_mask, cross, steps, 2.0)


def test_bf16_decode_weights_give_autocasts_bits(model):
    # the graph's weights: bf16 copies swapped in, so autocast casts none
    # of them; the decode must be the eager loop's bit for bit
    text, pos_text = (torch.as_tensor(x) for x in _text(6))
    model.amp = True
    try:
        with torch.inference_mode():
            weights = synth.DecodeWeights(model)
            ref = _amp_decode(model, text.long(), pos_text, 6)
            got = _amp_decode(model, text.long(), pos_text, 6, weights)
    finally:
        model.amp = False
    assert ref["groups"].abs().max() > 0
    assert torch.equal(got["groups"], ref["groups"])
    assert torch.equal(got["length"], ref["length"])


def test_bf16_decode_weights_cover_the_step_and_refresh_in_place(model):
    model.amp = True
    try:
        with torch.inference_mode():
            weights = synth.DecodeWeights(model)
    finally:
        model.amp = False
    linear = [m for part in (model.decoder, model.out, model.stop_token)
              for m in part.modules()
              if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d))]
    assert {id(m) for m, _, _ in weights.slots} == {id(m) for m in linear}
    assert all(c.dtype == torch.bfloat16 for _, _, c in weights.slots)
    assert not any(isinstance(m, torch.nn.LayerNorm)
                   for m, _, _ in weights.slots)
    before = [m._parameters[n] for m, n, _ in weights.slots]
    with weights.swapped_in():
        assert model.stop_token.bias.dtype == torch.bfloat16
    assert [m._parameters[n] for m, n, _ in weights.slots] == before
    slot = next(s for s in weights.slots if s[0] is model.stop_token
                and s[1] == "bias")
    address = slot[2].data_ptr()
    old = model.stop_token.bias.detach().clone()
    try:
        with torch.no_grad():
            model.stop_token.bias.fill_(-3.0)
        with torch.inference_mode():
            weights.refresh()
        assert slot[2].data_ptr() == address      # the graph's address
        assert torch.equal(slot[2], torch.full_like(slot[2], -3.0))
    finally:
        with torch.no_grad():
            model.stop_token.bias.copy_(old)
    with torch.inference_mode():
        weights.refresh()
    assert torch.equal(slot[2], old.to(torch.bfloat16))


def test_fp32_model_keeps_no_decode_weight_copies(model):
    assert not model.amp
    assert synth.DecodeWeights(model).slots == []


def _weight_casts(model, run) -> int:
    """Casts (``aten.to``, ``aten._to_copy``) of the model's parameters to
    another dtype while ``run()`` runs: autocast's casts of the weights."""
    from torch.utils._python_dispatch import TorchDispatchMode
    params = {p.data_ptr(): p.dtype for p in model.parameters()}
    casts = (torch.ops.aten.to, torch.ops.aten._to_copy)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket in casts
                    and args[0].data_ptr() in params
                    and out.dtype != params[args[0].data_ptr()]):
                self.n += 1
            return out

    with Count() as count:
        run()
    return count.n


def test_decode_step_casts_no_weight_with_the_copies_in(model):
    text, pos_text = (torch.as_tensor(x) for x in _text(4))
    src_mask = pad_mask(pos_text)
    model.amp = True
    try:
        with torch.inference_mode():
            e_outputs, _ = model.encode(text.long(), src_mask)
            cross = model.precompute_cross_kv(e_outputs)
            weights = synth.DecodeWeights(model)

            def step():
                synth.ar_decode(model, e_outputs, src_mask, cross, 1, 2.0)
            plain = _weight_casts(model, step)
            with weights.swapped_in():
                swapped = _weight_casts(model, step)
    finally:
        model.amp = False
    assert plain > 0 and swapped == 0
