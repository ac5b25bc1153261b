"""The port's tensor-parallel products under autocast, and its split AR
decode and GST paths, against one process, on two gloo ranks of the CPU.

Under CPU bf16 autocast each split block (a transformer attention block,
with and without ``concat_after``, a relative one, ``ConvFeedForward`` at
kernel 5 and ``ConformerFeedForward``) gives one process's output, input
gradients and weight gradients: at most 1 % of their elements differ, and
none by more than one bf16 ulp; its forward and its backward each take
one all-reduce. A rank that rounded its own partial
product, or its own part of an input gradient, before the sum over the
group fails that bound. In fp32 at dropout 0 the split AR model's eager
decode (KV caches of a rank's heads) gives one process's mels and stop
lengths, so do GST's train step (the style token attention split too) and
its ``ref_mel`` synthesis; the graphed decode and ``ar_segment`` refuse a
split model on every rank before any capture.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch import nn

from test_torch_port_parallel import TIGHT, free_port, worst
from test_torch_port_tp import (ar_batch, gathered, hparams, port_state,
                                port_weights)
from transformer_tts_tpu_torch.ops.attention import (
    MultiHeadAttention, RelativeMultiHeadAttention)
from transformer_tts_tpu_torch.ops.feedforward import (ConformerFeedForward,
                                                       ConvFeedForward)
from transformer_tts_tpu_torch.train import trainer as tr

# (B, T, d): 4 heads of 16, 2 a rank; FFN widths 256 (conv) and 128
B, T, D = 2, 24, 64
BLOCKS = ("attention", "concat_after", "relative", "conv_ff",
          "conformer_ff")
MOST_APART = 0.01               # share of elements that may differ
DECODE_STEPS = 24
MEL_TOL = 1e-5                  # of max|ref|


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small models: one intra-op thread each, so the module's tests (and
    the spawned ranks) do not spin against the other test workers for the
    host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the blocks ----------------------------------------------------------

def block(kind: str) -> nn.Module:
    """A block of width D with weights from a seed, dropout 0; the
    conformer FFN without its LayerNorm, so that its input's gradient is
    ``linear1``'s."""
    torch.manual_seed(5)
    if kind in ("attention", "concat_after"):
        return MultiHeadAttention(4, D, 0.0,
                                  concat_after=kind == "concat_after")
    if kind == "relative":
        m = RelativeMultiHeadAttention(4, D, 0.0)
        with torch.no_grad():
            m.pos_bias_u.normal_()
            m.pos_bias_v.normal_()
        return m
    if kind == "conv_ff":
        return ConvFeedForward(D, 5, 0.0)
    m = ConformerFeedForward(D, 2 * D, 0.0)
    m.layer_norm = nn.Identity()
    return m


def block_inputs(kind: str):
    """{name: fp32 input}, each input of its own (so each gradient is one
    layer's) and the output's bf16 gradient."""
    rs = np.random.RandomState(7)
    names = {"attention": ("q", "k", "v"), "concat_after": ("q", "k", "v"),
             "relative": ("q", "k", "v", "pos")}.get(kind, ("x",))
    xs = {n: torch.from_numpy(rs.randn(1 if n == "pos" else B, T, D)
                              .astype(np.float32)) for n in names}
    grad = torch.from_numpy(rs.randn(B, T, D).astype(np.float32))
    return xs, grad.bfloat16()


def run_block(kind: str, module: nn.Module) -> dict:
    """One forward and backward under CPU bf16 autocast: the output, the
    inputs' gradients and the parameters' (gathered whole on a split
    module)."""
    from transformer_tts_tpu_torch.parallel import tp
    xs, grad = block_inputs(kind)
    leaves = {n: x.clone().requires_grad_() for n, x in xs.items()}
    with torch.autocast("cpu", dtype=torch.bfloat16):
        if kind == "conv_ff":
            out = module.inner(leaves["x"])
        elif kind == "conformer_ff":
            out = module(leaves["x"])
        else:
            out, _ = module(*leaves.values())
    out.backward(grad)
    got = {"out": out.detach().float()}
    got.update({f"d{n}": x.grad for n, x in leaves.items()})
    for name, p in module.named_parameters():
        g = p.grad
        shard = getattr(p, "tp_shard", None)
        if shard is not None:
            g = tp._gather(g, shard, module.tp.group)
        got[name] = g
    return got


def bf16_apart(got: torch.Tensor, want: torch.Tensor):
    """(the share of elements that differ, the most bf16 ulps, at the
    larger of the two magnitudes, that an element differs by)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(
        torch.finfo(torch.bfloat16).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((diff > 0).float().mean()), float((diff / ulp).max())


# ---- the ranks -----------------------------------------------------------

def _split_ar(hp, weights):
    """The AR model of ``hp`` on ``weights``, split over the world."""
    from transformer_tts_tpu_torch.models import build_model
    from transformer_tts_tpu_torch.parallel import tensor_parallel
    model = build_model(hp, device="cpu")
    model.load_state_dict(weights)
    assert tensor_parallel(model, dist.group.WORLD) > 0
    return model.eval()


def _refusals(model, text, pos_text) -> list:
    """The messages the graphed decode and ``ar_segment`` raise for a split
    model: checked before any capture or device call (the segment is given
    meta tensors, the graphed decode the CPU's)."""
    from transformer_tts_tpu_torch.infer import synthesize as syn
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    src_mask = pad_mask(pos_text)
    with torch.no_grad():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
    carry = syn._ar_init(model, text.shape[0], 8, "cpu")
    messages = []
    for call in (lambda: syn.ar_decode_graphed(model, e_outputs, src_mask,
                                               cross, 8, 0.5),
                 lambda: syn.ar_segment(model, carry, e_outputs.to("meta"),
                                        src_mask.to("meta"), cross, 8,
                                        0.5)):
        try:
            call()
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    return messages


def _decode(weights, threshold, text, pos_text, ref_mel=None, gst=False):
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    model = _split_ar(hparams("ar", gst=gst), weights)
    mel, lengths = synthesize_transformer_tts(
        model, text, pos_text, ref_mel=ref_mel, max_steps=DECODE_STEPS,
        stop_threshold=threshold)
    out = {"mel": mel, "lengths": lengths}
    if not gst:
        out["refusals"] = _refusals(model, text, pos_text)
    return out


def _gst_step(weights):
    from transformer_tts_tpu_torch.parallel import make_mesh
    hp = hparams("ar", gst=True)
    state = tr.distribute(gst_state(hp, weights), "cpu",
                          make_mesh(1, 2, device="cpu"))
    state, logs = tr.make_transformer_train_step(hp, device="cpu")(
        state, ar_batch())
    out = gathered(state, logs)
    tokens = state.model.style_embedding.style_token_layer.attention
    out["tokens_split"] = tokens.tp is not None
    return out


def _blocks():
    """Each split block's ``run_block``, and the all-reduces its forward
    and backward issued."""
    from transformer_tts_tpu_torch.parallel import tensor_parallel
    out, calls = {}, {}
    real = dist.all_reduce

    def counting(*args, **kwargs):
        calls[kind] += 1
        return real(*args, **kwargs)

    dist.all_reduce = counting
    try:
        for kind in BLOCKS:
            module = block(kind)
            assert tensor_parallel(module, dist.group.WORLD) == 1
            calls[kind] = 0
            out[kind] = run_block(kind, module)
    finally:
        dist.all_reduce = real
    return out, calls


def _rank_main(rank, world, port, jobs, out_dir):
    from transformer_tts_tpu_torch.parallel import init_distributed
    torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        blocks, all_reduces = _blocks()
        results = {"blocks": blocks, "all_reduces": all_reduces,
                   "decode": _decode(**jobs["decode"]),
                   "gst_synthesis": _decode(**jobs["gst_synthesis"],
                                            gst=True),
                   "gst_step": _gst_step(**jobs["gst_step"])}
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---- one process ---------------------------------------------------------

def gst_state(hp, weights):
    """``port_state`` with the style token attention at dropout 0 (its rate
    is fixed at 0.1)."""
    state = port_state(hp, weights)
    state.model.style_embedding.style_token_layer.attention.dropout.p = 0.0
    return state


def decode_inputs():
    rs = np.random.RandomState(21)
    lengths = (12, 9)
    pos_text = np.where(np.arange(12)[None] < np.asarray(lengths)[:, None],
                        np.arange(1, 13)[None], 0)
    text = np.where(pos_text > 0, rs.randint(1, 40, (2, 12)), 0)
    ref_mel = rs.randn(1, 40, 16).astype(np.float32)
    return (torch.from_numpy(text).long(), torch.from_numpy(pos_text).long(),
            torch.from_numpy(ref_mel))


def one_process_decode(hp, weights, threshold, text, pos_text, ref_mel=None):
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    from transformer_tts_tpu_torch.models import build_model
    model = build_model(hp, device="cpu")
    model.load_state_dict(weights)
    return synthesize_transformer_tts(
        model.eval(), text, pos_text, ref_mel=ref_mel,
        max_steps=DECODE_STEPS, stop_threshold=threshold)


@pytest.fixture(scope="module")
def jobs():
    """The ranks' inputs: the AR and GST weights, and a stop threshold at
    which the AR model's row 0 stops early and row 1 later or never."""
    from test_torch_port_ar import _forced_threshold, _stop_probs
    from transformer_tts_tpu_torch.models import build_model
    text, pos_text, ref_mel = decode_inputs()
    ar = port_weights(hparams("ar"))
    model = build_model(hparams("ar"), device="cpu")
    model.load_state_dict(ar)
    threshold = _forced_threshold(_stop_probs(model.eval(), text, pos_text,
                                              DECODE_STEPS))
    gst = port_weights(hparams("ar", gst=True))
    return {"decode": dict(weights=ar, threshold=threshold, text=text,
                           pos_text=pos_text),
            # a threshold above every probability: no row stops
            "gst_synthesis": dict(weights=gst, threshold=1.0, text=text,
                                  pos_text=pos_text, ref_mel=ref_mel),
            "gst_step": dict(weights=gst)}


@pytest.fixture(scope="module")
def two_ranks(jobs, tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("tp_amp"))
    mp.spawn(_rank_main, args=(2, free_port(), jobs, out_dir), nprocs=2,
             join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]


# ---- the tests -----------------------------------------------------------

@pytest.mark.parametrize("kind", BLOCKS)
def test_split_block_under_amp_rounds_as_one_process(two_ranks, kind):
    want = run_block(kind, block(kind))
    for rank in range(2):
        got = two_ranks[rank]["blocks"][kind]
        assert sorted(got) == sorted(want)
        for name, value in want.items():
            if value is None:               # a norm that ``inner`` skips
                assert got[name] is None, name
                continue
            assert got[name].shape == value.shape, name
            share, ulps = bf16_apart(got[name], value)
            assert share <= MOST_APART and ulps <= 1.0, (
                f"rank {rank} {kind} {name}: {share:.4f} of the elements "
                f"differ, by up to {ulps:.3g} bf16 ulps")


def test_split_block_takes_one_all_reduce_each_way(two_ranks):
    """A block's row-split output is summed in one all-reduce forward, and
    its column-split layers' input gradients (q, k, v and the relative
    block's positions, rounded each on its own) in one backward."""
    for rank in range(2):
        assert two_ranks[rank]["all_reduces"] == {k: 2 for k in BLOCKS}


def test_bf16_apart_counts_one_rounding_of_a_sum():
    """The bound fails a sum of two bf16-rounded halves against the whole
    sum rounded once, as each rank's own rounding of its partial gave."""
    rs = np.random.RandomState(3)
    a, b = (torch.from_numpy(rs.randn(64, 96).astype(np.float32)) * 1e-2
            for _ in range(2))
    x = torch.from_numpy(rs.randn(96, 128).astype(np.float32))
    once = (a @ x + b @ x).bfloat16()
    halves = ((a @ x).bfloat16().float()
              + (b @ x).bfloat16().float()).bfloat16()
    share, _ = bf16_apart(halves, once)
    assert share > MOST_APART
    assert bf16_apart(once, once) == (0.0, 0.0)


def test_split_ar_eager_decode_equals_one_process(two_ranks, jobs):
    job = jobs["decode"]
    mel, lengths = one_process_decode(hparams("ar"), job["weights"],
                                      job["threshold"], job["text"],
                                      job["pos_text"])
    assert lengths[0] < DECODE_STEPS * 2        # row 0 stops inside
    scale = float(mel.abs().max())
    for rank in range(2):
        got = two_ranks[rank]["decode"]
        assert torch.equal(got["lengths"], lengths), rank
        err = float((got["mel"] - mel).abs().max())
        assert err <= MEL_TOL * scale, (rank, err / scale)


def test_graphed_decode_and_segment_refuse_a_split_model(two_ranks):
    for rank in range(2):
        for message in two_ranks[rank]["decode"]["refusals"]:
            assert message is not None, rank
            assert "cannot be captured" in message
            assert "eager=True" in message


def test_split_gst_step_equals_single_process(two_ranks, jobs):
    hp = hparams("ar", gst=True)
    state = gst_state(hp, jobs["gst_step"]["weights"])
    tr.fold_rank(state, 0)
    state, logs = tr.make_transformer_train_step(hp, device="cpu")(
        state, ar_batch())
    ref = gathered(state, logs)
    for rank in range(2):
        got = two_ranks[rank]["gst_step"]
        assert got["tokens_split"], rank
        assert worst(got, ref, TIGHT) <= 1.0, rank


def test_split_gst_ref_mel_synthesis_equals_one_process(two_ranks, jobs):
    job = jobs["gst_synthesis"]
    mel, lengths = one_process_decode(hparams("ar", gst=True), job["weights"],
                                      job["threshold"], job["text"],
                                      job["pos_text"], job["ref_mel"])
    scale = float(mel.abs().max())
    for rank in range(2):
        got = two_ranks[rank]["gst_synthesis"]
        assert torch.equal(got["lengths"], lengths), rank
        err = float((got["mel"] - mel).abs().max())
        assert err <= MEL_TOL * scale, (rank, err / scale)
