"""The port's conformer FastSpeech 2 against the JAX package, on the CPU.

Module by module (relative positions, rel_shift, the conformer FFN and
conv module, relative attention on both paths, the layer and the stack)
at 1e-5 abs/rel in fp32, the whole model and ``synthesize_fastspeech2``
at 1e-4 (d 32, 2+2 layers, 2 heads). The kernel K4's plain version is
held against the JAX package's Pallas kernel in interpret mode and its
jnp oracle at 2e-5, and a numpy emulation of the CUDA kernel's tiling
(the three-branch identity read along the skew of a P window) is held
against the plain version. The CUDA kernel itself is held against the
plain version on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.compat.torch_import import (
    convert_conformer_encoder_state_dict)
from transformer_tts_tpu.config import HParams as JaxHParams
from transformer_tts_tpu.infer.synthesize import (
    synthesize_fastspeech2 as jax_synthesize)
from transformer_tts_tpu.models.encoder import (
    ConformerEncoder as JConformerEncoder)
from transformer_tts_tpu.models.layers import (
    ConformerEncoderLayer as JConformerEncoderLayer)
from transformer_tts_tpu.ops import positional as jpos
from transformer_tts_tpu.ops.attention import (
    RelativeMultiHeadAttention as JRelativeMultiHeadAttention,
    rel_shift as jax_rel_shift)
from transformer_tts_tpu.ops.feedforward import (
    ConformerConvModule as JConformerConvModule,
    ConformerFeedForward as JConformerFeedForward)
from transformer_tts_tpu.ops.flash_relpos import (
    flash_relpos_attention as jax_flash_relpos, reference_relpos_attention)
from transformer_tts_tpu.ops.masks import pad_mask as jax_pad_mask
from transformer_tts_tpu.train import schedule as jax_schedule
from transformer_tts_tpu.train.trainer import (
    TrainState as JaxTrainState,
    make_fastspeech2_train_step as jax_train_step)
from transformer_tts_tpu_torch.cli import synthesize as cli
from transformer_tts_tpu_torch.cli import train as train_cli
from transformer_tts_tpu_torch.compat.from_jax import state_dict_from_flax
from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.infer.synthesize import (
    synthesize_fastspeech2)
from transformer_tts_tpu_torch.models.fastspeech2 import build_fastspeech2
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops import flash_relpos, positional
from transformer_tts_tpu_torch.ops.flash_relpos import (
    check_relpos_inputs, flash_relpos_attention,
    flash_relpos_attention_fwd_reference)
from transformer_tts_tpu_torch.ops.masks import pad_mask
from transformer_tts_tpu_torch.train import schedule
from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, make_fastspeech2_train_step)

from test_torch_port_train import (
    _corpus, _jax_grads, _train_batch, _write_hp)
from torch_port_pair import CONFORMER, SMALL, build_pair, to_np


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def pair():
    return build_pair(**CONFORMER)


def _close(a, b, **tol):
    np.testing.assert_allclose(to_np(a), to_np(b), **(tol or TOL))


def _features(seed, b=2, t=12, d=32):
    return np.random.RandomState(seed).randn(b, t, d).astype(np.float32)


def _prefix_mask(t, lengths):
    return (np.arange(t)[None] < np.asarray(lengths)[:, None])[:, None, :]


def _variables(pair, *path):
    """{"params", "batch_stats"} of the sub-module at ``path``."""
    _, _, variables, _ = pair
    out = {}
    for col in ("params", "batch_stats"):
        node = variables[col]
        for key in path:
            node = node.get(key, {})
        if node:
            out[col] = node
    return out


# ---- relative positions -----------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2, 6, 6), (1, 3, 9, 9), (2, 2, 4, 7)])
def test_rel_shift_matches_jax(shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ours = port_attention.rel_shift(torch.as_tensor(x))
    _close(ours, jax_rel_shift(jnp.asarray(x)), rtol=0, atol=0)


@pytest.mark.parametrize("d_model", [32, 96])
def test_relative_sinusoid_table_matches_jax(d_model):
    # 300 positions, as tests/test_torch_port_ops.py: sin/cos of large
    # angles differ by a few fp32 ulps of the angle between libraries
    ours = positional.relative_sinusoid_table(300, d_model)
    ref = jpos.relative_sinusoid_table(300, d_model)
    _close(ours, ref)


def test_relative_positional_encoder_matches_jax():
    x = _features(1, t=40)
    x_ref, pe_ref = jpos.RelativePositionalEncoder(32, dropout=0.0).apply(
        {}, jnp.asarray(x), train=False)
    enc = positional.RelativePositionalEncoder(32, dropout=0.0)
    x_ours, pe_ours = enc(torch.as_tensor(x))
    _close(x_ours, x_ref, rtol=0, atol=0)
    assert pe_ours.shape == (1, 40, 32)
    _close(pe_ours, pe_ref)
    with pytest.raises(ValueError, match="exceeds"):
        enc(torch.zeros(1, positional.MAX_REL_POSITIONS + 1, 32))


# ---- K4's plain version -----------------------------------------------------

def _relpos_inputs(t, k_len, b=2, h=2, d=8, seed=0):
    rs = np.random.RandomState(seed)
    qu, qv, k, v = (rs.randn(b, h, t, d).astype(np.float32)
                    for _ in range(4))
    p = rs.randn(h, t, d).astype(np.float32)
    return qu, qv, k, v, p, np.asarray(k_len, np.int32)


def _logsumexp(qu, qv, k, p, k_len, sm_scale):
    """Row logsumexp of the masked logits, in numpy float64."""
    t = qu.shape[2]
    ac = np.einsum("bhqd,bhkd->bhqk", qu, k).astype(np.float64)
    bd = np.einsum("bhqd,hkd->bhqk", qv, p).astype(np.float64)
    s = (ac + np.asarray(jax_rel_shift(jnp.asarray(bd)))) * sm_scale
    s = np.where(np.arange(t)[None, None, None] < k_len[:, None, None, None],
                 s, -np.inf)
    m = s.max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("t,k_len,block_q,block_k", [
    (48, [48, 24], 16, 16),
    (37, [37, 18], 16, 32),        # T not a multiple of the blocks
    (50, [50, 25], 32, 16),
    (16, [16, 8], 64, 64),         # one block larger than T
    (40, [0, 25], 16, 16),         # a row with no valid key
])
def test_plain_version_matches_interpret_kernel(t, k_len, block_q, block_k):
    # the blocks of tests/test_flash_relpos.py:30-31
    qu, qv, k, v, p, kl = _relpos_inputs(t, k_len, d=16, seed=t)
    sm_scale = 16 ** -0.5
    jargs = [jnp.asarray(a) for a in (qu, qv, k, v, p, kl)]
    jo = jax_flash_relpos(*jargs, block_q=block_q, block_k=block_k,
                          interpret=True)
    jref = reference_relpos_attention(*jargs)
    o, lse = flash_relpos_attention_fwd_reference(
        *(torch.as_tensor(a) for a in (qu, qv, k, v, p, kl)), sm_scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **KERNEL_TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jref), **KERNEL_TOL)
    want = _logsumexp(qu, qv, k, p, kl, sm_scale)
    valid = kl > 0
    np.testing.assert_allclose(lse.numpy()[valid], want[valid], **KERNEL_TOL)
    if not valid.all():
        assert np.all(o.numpy()[~valid] == 0)
        assert np.all(lse.numpy()[~valid] == np.float32(-1e30))


def _rows(x, row0, n):
    """Rows row0 .. row0+n-1 of x (T, d), zero outside [0, T)."""
    out = np.zeros((n, x.shape[1]))
    lo, hi = max(row0, 0), min(row0 + n, x.shape[0])
    if hi > lo:
        out[lo - row0:hi - row0] = x[lo:hi]
    return out


def _kernel_tiling(qu, qv, k, v, p, k_len, sm_scale, bq, bk):
    """numpy float64 emulation of csrc/flash_relpos_fwd.cu: q tiles of
    bq rows, k tiles of bk keys, the bias of each tile from one P window
    per branch read along the skew, branches and k tiles skipped by the
    kernel's rules, online softmax."""
    b, h, t, d = qu.shape
    o = np.zeros(qu.shape)
    lse = np.zeros((b, h, t))
    r = np.arange(bq)[:, None]
    c = np.arange(bk)[None, :]
    for bi in range(b):
        klen = int(k_len[bi])
        for hi in range(h):
            for q0 in range(0, t, bq):
                tqu = _rows(qu[bi, hi], q0, bq)
                tqv = _rows(qv[bi, hi], q0, bq + 1)
                m = np.full(bq, -1e30)
                l = np.zeros(bq)
                acc = np.zeros((bq, d))
                for k0 in range(0, klen, bk):
                    s = tqu @ _rows(k[bi, hi], k0, bk).T
                    rel = (k0 + c) - (q0 + r)
                    for br in (0, 1):
                        used = (k0 <= q0 + bq - 1 if br == 0
                                else k0 + bk - 1 >= q0 + 2)
                        if not used:
                            continue
                        base = (t - bq + k0 - q0 if br == 0
                                else k0 - q0 - bq - 1)
                        a = tqv[br:br + bq] @ _rows(p[hi], base, bq + bk).T
                        sel = rel <= 0 if br == 0 else rel >= 2
                        s = s + np.where(sel, a[r, c - r + bq - 1], 0.0)
                    s = s * sm_scale
                    valid = (k0 + c) < klen
                    m_new = np.maximum(m, np.where(valid, s, -1e30).max(1))
                    pr = np.where(valid, np.exp(s - m_new[:, None]), 0.0)
                    alpha = np.exp(m - m_new)
                    l = alpha * l + pr.sum(1)
                    acc = alpha[:, None] * acc + pr @ _rows(v[bi, hi], k0,
                                                            bk)
                    m = m_new
                safe_l = np.where(l > 0, l, 1.0)
                n = min(bq, t - q0)
                o[bi, hi, q0:q0 + n] = (acc / safe_l[:, None])[:n]
                lse[bi, hi, q0:q0 + n] = (m + np.log(safe_l))[:n]
    return o, lse


@pytest.mark.parametrize("t,k_len,block", [
    (150, [150, 0], 64),        # the kernel's own tiles, a ragged T
    (100, [1, 65], 16),         # many tiles: every branch-skip case
    (64, [64, 63], 16),
])
def test_kernel_tiling_matches_plain_version(t, k_len, block):
    qu, qv, k, v, p, kl = _relpos_inputs(t, k_len, d=8, seed=t + block)
    sm_scale = 8 ** -0.5
    o, lse = _kernel_tiling(qu, qv, k, v, p, kl, sm_scale, block, block)
    ro, rlse = flash_relpos_attention_fwd_reference(
        *(torch.as_tensor(a) for a in (qu, qv, k, v, p, kl)), sm_scale)
    np.testing.assert_allclose(o, ro.numpy(), **KERNEL_TOL)
    np.testing.assert_allclose(lse, rlse.numpy(), **KERNEL_TOL)


def test_wrapper_on_cpu_takes_plain_version_and_launches_nothing():
    args = [torch.as_tensor(a) for a in _relpos_inputs(30, [30, 21])]
    before = flash_relpos_attention.launches
    o, lse = flash_relpos_attention(*args)
    ro, rlse = flash_relpos_attention_fwd_reference(*args, 8 ** -0.5)
    assert flash_relpos_attention.launches == before
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


@pytest.mark.parametrize("kind,error", [
    ("cross", ValueError), ("p_shape", ValueError),
    ("q_v_dtype", TypeError), ("p_contiguity", ValueError)])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(kind, error):
    qu, qv, k, v, p, kl = (torch.as_tensor(a)
                           for a in _relpos_inputs(16, [16, 9]))
    if kind == "cross":
        k = v = torch.zeros(2, 2, 20, 8)
    elif kind == "p_shape":
        p = p[:, :8]
    elif kind == "q_v_dtype":
        qv = qv.bfloat16()
    elif kind == "p_contiguity":
        p = torch.zeros(2, 8, 16).transpose(1, 2)
    with pytest.raises(error):
        check_relpos_inputs(qu, qv, k, v, p, kl)


# ---- conformer modules ------------------------------------------------------

def test_conformer_feed_forward_matches_jax(pair):
    model = pair[3]
    x = _features(2)
    ref = JConformerFeedForward(32, 64, dropout=0.0).apply(
        _variables(pair, "encoder", "layers_0", "ff_1"), jnp.asarray(x),
        train=False)
    with torch.no_grad():
        ours = model.encoder.layers[0].ff_1(torch.as_tensor(x))
    _close(ours, ref)


def test_conformer_conv_module_matches_jax(pair):
    # eval mode: BatchNorm reads the pair's non-trivial running stats
    model = pair[3]
    x = _features(3, t=40)
    variables = _variables(pair, "decoder", "layers_1", "conv_module")
    assert "batch_stats" in variables
    ref = JConformerConvModule(32, dropout=0.0).apply(
        variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        ours = model.decoder.layers[1].conv_module(torch.as_tensor(x))
    _close(ours, ref)


def _relative_attention_pair(pair, t, lengths, *, k_len):
    model = pair[3]
    x = _features(4, t=t)
    pe = positional.relative_sinusoid_table(t, 32)[None]
    mask = _prefix_mask(t, lengths)
    ref, ref_probs = JRelativeMultiHeadAttention(
        heads=2, d_model=32, dropout=0.0).apply(
        _variables(pair, "decoder", "layers_0", "attn"), jnp.asarray(x),
        jnp.asarray(x), jnp.asarray(x), jnp.asarray(pe.numpy()),
        jnp.asarray(mask), train=False, collect_attn=k_len is None)
    xt = torch.as_tensor(x)
    attn = model.decoder.layers[0].attn
    with torch.no_grad():
        ours, probs = attn(
            xt, xt, xt, pe, torch.as_tensor(mask),
            collect_attn=k_len is None,
            k_len=None if k_len is None else torch.as_tensor(k_len))
    return ours, probs, ref, ref_probs


def test_relative_attention_masked_path_matches_jax(pair):
    ours, probs, ref, ref_probs = _relative_attention_pair(
        pair, 20, [20, 13], k_len=None)
    _close(ours, ref)
    _close(probs, ref_probs)


def test_relative_attention_kernel_path_matches_jax(pair, monkeypatch):
    # T >= FLASH_MIN_KEY_LEN with a prefix mask: the port goes to K4 (its
    # plain version on the CPU), JAX on the CPU to its masked path; with
    # every batch row holding a valid key they agree on every row
    calls = []
    real = port_attention.flash_relpos_attention
    monkeypatch.setattr(port_attention, "flash_relpos_attention",
                        lambda *a, **kw: calls.append(a[4].shape)
                        or real(*a, **kw))
    t = port_attention.FLASH_MIN_KEY_LEN
    lengths = np.array([t, 100], np.int32)
    ours, probs, ref, _ = _relative_attention_pair(pair, t, lengths,
                                                   k_len=lengths)
    assert calls == [(2, t, 16)] and probs is None
    _close(ours, ref)


def _train_attention(dropout, seed):
    attn = port_attention.RelativeMultiHeadAttention(
        2, 32, dropout=dropout, use_flash=True)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for prm in attn.parameters():
            prm.copy_(torch.randn(prm.shape, generator=gen) * 0.3)
    return attn.train()


def _attention_grads(attn, k_len, generator=None):
    t = port_attention.FLASH_MIN_KEY_LEN
    x = torch.as_tensor(_features(9, t=t))
    pe = positional.relative_sinusoid_table(t, 32)[None]
    mask = torch.as_tensor(_prefix_mask(t, [t, 100]))
    w = torch.as_tensor(np.random.RandomState(10).randn(2, t, 32)
                        .astype(np.float32))
    out, _ = attn(x, x, x, pe, mask, k_len=k_len, generator=generator)
    names = ("q_linear.weight", "k_linear.weight", "v_linear.weight",
             "linear_pos.weight", "pos_bias_u", "pos_bias_v")
    params = dict(attn.named_parameters())
    grads = torch.autograd.grad((out * w).sum(), [params[n] for n in names])
    return out.detach(), dict(zip(names, grads))


def test_kernel_path_in_train_mode_gives_the_masked_paths_gradients(
        monkeypatch):
    # the kernel path's gradient comes from the tts_port::relpos_fwd op's backward
    # (K5's plain version here, the kernels on the card), not from autograd
    # through the forward: every decoder self-attention parameter gets the
    # masked path's gradient
    calls = []
    real = flash_relpos.flash_relpos_attention_bwd
    monkeypatch.setattr(flash_relpos, "flash_relpos_attention_bwd",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    attn = _train_attention(0.0, 0)
    t = port_attention.FLASH_MIN_KEY_LEN
    out, grads = _attention_grads(attn, torch.tensor([t, 100]))
    ref_out, ref_grads = _attention_grads(attn, None)
    assert calls == [1]
    _close(out, ref_out)
    for name, g in grads.items():
        want = ref_grads[name].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_kernel_path_dropout_seed_comes_from_the_generator(monkeypatch):
    seen = []
    real = port_attention.flash_relpos_attention

    def recording(*args, **kw):
        seen.append((kw["dropout_rate"], kw["dropout_seed"]))
        return real(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_relpos_attention", recording)
    t = port_attention.FLASH_MIN_KEY_LEN
    k_len = torch.tensor([t, 100])
    runs = [_attention_grads(_train_attention(0.1, 0), k_len,
                             torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert [r for r, _ in seen] == [0.1] * 3
    assert seen[0][1] == seen[1][1] != seen[2][1]
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name
    assert not torch.equal(runs[0][0], runs[2][0])
    no_dropout, _ = _attention_grads(_train_attention(0.0, 0), k_len)
    assert not torch.allclose(runs[0][0], no_dropout)


def test_autocast_hands_the_kernel_one_dtype(monkeypatch):
    # under bf16 autocast q, k, v and p come out of Linear layers in bf16
    # while pos_bias_u/v stay fp32 parameters: q_u and q_v must not be
    # promoted to fp32
    seen = []
    real = port_attention.flash_relpos_attention

    def recording(*args, **kw):
        seen.append({a.dtype for a in args[:5]})
        return real(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_relpos_attention", recording)
    attn = port_attention.RelativeMultiHeadAttention(
        2, 32, dropout=0.0, use_flash=True).eval()
    t = port_attention.FLASH_MIN_KEY_LEN
    x = torch.as_tensor(_features(5, b=1, t=t))
    pe = positional.relative_sinusoid_table(t, 32)[None]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out, _ = attn(x, x, x, pe, torch.ones(1, 1, t, dtype=torch.bool),
                      k_len=torch.tensor([t]))
    assert seen == [{torch.bfloat16}]
    assert torch.isfinite(out.float()).all()


def test_conformer_encoder_layer_matches_jax(pair):
    model = pair[3]
    x = _features(6)
    mask = _prefix_mask(12, [12, 9])
    pe = positional.relative_sinusoid_table(12, 32)[None]
    ref, _ = JConformerEncoderLayer(32, 2, 5, dropout=0.0).apply(
        _variables(pair, "encoder", "layers_1"), jnp.asarray(x),
        jnp.asarray(pe.numpy()), jnp.asarray(mask), train=False)
    with torch.no_grad():
        ours, _ = model.encoder.layers[1](torch.as_tensor(x), pe,
                                          torch.as_tensor(mask))
    _close(ours, ref)


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_conformer_encoder_matches_jax(pair, stack):
    model = pair[3]
    rs = np.random.RandomState(7)
    if stack == "encoder":
        src = rs.randint(1, 40, (2, 12)).astype(np.int32)
        src[1, 8:] = 0
        mask = _prefix_mask(12, [12, 8])
        jmod = JConformerEncoder(40, 32, 2, 2, 5, dropout=0.0)
        src_t = torch.as_tensor(src).long()
    else:
        src = _features(8, t=30)
        mask = _prefix_mask(30, [30, 17])
        jmod = JConformerEncoder(32, 32, 2, 2, 1, dropout=0.0,
                                 embedding=False)
        src_t = torch.as_tensor(src)
    ref, _ = jmod.apply(_variables(pair, stack), jnp.asarray(src),
                        jnp.asarray(mask), train=False)
    with torch.no_grad():
        ours, _ = getattr(model, stack)(src_t, torch.as_tensor(mask))
    _close(ours, ref)


# ---- the whole model --------------------------------------------------------

def test_weight_round_trip(pair):
    hp, _, variables, model = pair
    state = model.state_dict()
    for stack, n_layers in (("encoder", hp.n_layer_encoder),
                            ("decoder", hp.n_layer_decoder)):
        params, bstats = convert_conformer_encoder_state_dict(
            state, n_layers, prefix=stack)
        for got, want in ((params, variables["params"][stack]),
                          (bstats, variables["batch_stats"][stack])):
            assert jax.tree.structure(got) == jax.tree.structure(want)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(a, b)


def _batch(seed, b=2, l=12, vocab=40):
    rs = np.random.RandomState(seed)
    text = rs.randint(1, vocab, (b, l)).astype(np.int32)
    text[1, l - 3:] = 0
    pos = np.where(text != 0, np.arange(1, l + 1)[None], 0).astype(np.int32)
    return text, pos


def test_forward_teacher_forced_matches_jax(pair):
    _, jmodel, variables, model = pair
    text, pos = _batch(1)
    rs = np.random.RandomState(2)
    t = 48
    d = rs.randint(0, 5, text.shape).astype(np.int32) * (text != 0)
    p = rs.uniform(60, 800, (2, t)).astype(np.float32)
    e = rs.uniform(0, 320, (2, t)).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(text),
                       jax_pad_mask(jnp.asarray(pos)), t, jnp.asarray(d),
                       jnp.asarray(p), jnp.asarray(e), train=False)
    with torch.no_grad():
        ours = model(torch.as_tensor(text), pad_mask(torch.as_tensor(pos)),
                     t, torch.as_tensor(d), torch.as_tensor(p),
                     torch.as_tensor(e))
    for field in ("mel_pre", "mel_post", "log_duration",
                  "variance_adaptor_output"):
        _close(getattr(ours, field), getattr(ref, field), **MODEL_TOL)
    for field in ("mel_len", "mel_pos"):
        np.testing.assert_array_equal(to_np(getattr(ours, field)),
                                      to_np(getattr(ref, field)))


@pytest.mark.parametrize("max_frames,text_len,kernel_calls", [
    (64, 12, 0),        # the masked path on both sides
    (256, 24, 2),       # the decoder goes to K4's plain version
])
def test_synthesize_matches_jax(pair, monkeypatch, max_frames, text_len,
                                kernel_calls):
    # all frames are compared, padded ones too: the depthwise conv (k=31)
    # carries padded frames into valid ones, and the kernel path and the
    # masked path agree on every row that has a valid key
    _, jmodel, variables, model = pair
    calls = []
    real = port_attention.flash_relpos_attention
    monkeypatch.setattr(port_attention, "flash_relpos_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    text, pos = _batch(3, l=text_len)
    rs = np.random.RandomState(4)
    mean = rs.randn(16).astype(np.float32)
    var = rs.uniform(0.5, 2.0, 16).astype(np.float32)
    rmel, rlen, rdur = jax_synthesize(
        jmodel, variables, jnp.asarray(text), jnp.asarray(pos), max_frames,
        mean=jnp.asarray(mean), var=jnp.asarray(var))
    mel, mel_len, dur = synthesize_fastspeech2(
        model, torch.as_tensor(text), torch.as_tensor(pos), max_frames,
        torch.as_tensor(mean), torch.as_tensor(var))
    assert len(calls) == kernel_calls
    np.testing.assert_array_equal(to_np(mel_len), to_np(rlen))
    np.testing.assert_array_equal(dur.numpy(), np.asarray(rdur))
    assert 0 < int(mel_len.min()) and int(mel_len.max()) < max_frames
    _close(mel, rmel, **MODEL_TOL)


def test_cli_synthesizes_conformer_on_cpu(tmp_path, monkeypatch):
    calls = []
    real = port_attention.flash_relpos_attention
    monkeypatch.setattr(port_attention, "flash_relpos_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = dict(SMALL, **CONFORMER, text_buckets=(8, 16))
    load_dir = tmp_path / "model"
    load_dir.mkdir()
    (load_dir / "hparams.py").write_text(
        "".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    model = build_fastspeech2(HParams(**cfg), device="cpu")
    with torch.no_grad():       # 3 frames per phone
        head = model.variance_adaptor.duration_predictor.linear_layer
        head.weight.zero_()
        head.bias.fill_(np.log(4.0))
    save_checkpoint(model, str(load_dir))
    script = tmp_path / "test.txt"
    script.write_text("a.npy|3 5 7 9\nb.npy|1 2 3 4 5 6 7 8 9 10\n")
    out_dir = tmp_path / "out"
    cli.main(["--load_name", str(load_dir), "--test_script", str(script),
              "--save", str(out_dir), "--max_frames", "256",
              "--batch_size", "2", "--device", "cpu"])
    assert len(calls) == SMALL["n_layer_decoder"]
    for idx, n_text in enumerate((4, 10)):
        mel = np.load(out_dir / f"{idx}.npy")
        align = np.load(out_dir / f"{idx}_alignment.npy")
        assert mel.dtype == np.float32 and mel.shape[1] == 16
        assert 0 < mel.shape[0] == min(256, int(align.sum()))
        assert np.isfinite(mel).all()
        assert not align[n_text:].any()


# ---- training ---------------------------------------------------------------

def test_conformer_train_step_matches_jax(monkeypatch):
    # every dropout 0 and a mel bucket of 256, so the port's decoder takes
    # K4's and K5's plain versions (JAX on the CPU its masked path)
    calls = []
    real = port_attention.flash_relpos_attention
    monkeypatch.setattr(port_attention, "flash_relpos_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    warmup = 10
    hp, jmodel, variables, model = build_pair(warmup_step=warmup,
                                              **CONFORMER)
    jhp = JaxHParams(**dict(SMALL, **CONFORMER, warmup_step=warmup))
    batch = _train_batch()
    tx = jax_schedule.build_optimizer(
        jhp.optimizer, jhp.d_model_decoder, jhp.warmup_factor,
        jhp.warmup_step, jhp.learning_rate, jhp.clip, jhp.accum_grad)
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"], vq_stats={}, tx=tx)
    new_jstate, jlogs = jax_train_step(jmodel, jhp, donate=False)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    host = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    jgrads = state_dict_from_flax(host(_jax_grads(jmodel, variables, batch)),
                                  variables["batch_stats"], hp)
    jnew = state_dict_from_flax(host(new_jstate.params),
                                host(new_jstate.batch_stats), hp)

    opt = schedule.build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    state = TrainState(model, opt, torch.Generator().manual_seed(0))
    old = {k: v.clone() for k, v in model.state_dict().items()}
    state, logs = make_fastspeech2_train_step(hp, device="cpu")(state,
                                                                  batch)
    assert state.step == 1
    assert len(calls) == SMALL["n_layer_decoder"]   # the decoder's kernel
    for key, value in jlogs.items():
        np.testing.assert_allclose(float(logs[key]), float(value),
                                   rtol=1e-4, err_msg=key)
    clip = min(1.0, 1.0 / float(jlogs["grad_norm"]))
    lr = schedule.noam_schedule(SMALL["d_model_decoder"], 1.0, warmup)(0)
    for name, p in model.named_parameters():
        want = jgrads[name].numpy() * clip
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
        # Adam's first step on gradients that are rounding noise (key
        # biases, conv biases before a BatchNorm) is any value in [-lr, lr]
        new, ref = p.detach().numpy(), jnew[name].numpy()
        settled = np.abs(want) > 1e-7
        np.testing.assert_allclose(new[settled], ref[settled], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        moved = np.abs(new - old[name].numpy())
        ulp = np.spacing(np.abs(old[name].numpy()))
        assert np.all(moved <= lr * 1.0001 + 2 * ulp), name
    attn = [f"decoder.layers.{i}.attn.{m}"
            for i in range(SMALL["n_layer_decoder"])
            for m in ("q_linear.weight", "k_linear.weight", "v_linear.weight",
                      "linear_pos.weight", "pos_bias_u", "pos_bias_v")]
    for name in attn:                    # K5's gradients reach every one
        assert float(dict(model.named_parameters())[name].grad.abs().max()) \
            > 0, name
    for name, value in model.state_dict().items():
        if "running" in name:                    # BatchNorm statistics
            np.testing.assert_allclose(value.numpy(), jnew[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)


def test_conformer_train_cli_then_synthesis_cli(tmp_path, capsys,
                                                monkeypatch):
    # a 256-frame mel bucket: the decoder takes K4-d and K5's plain
    # versions with dropout 0.1, each step drawing its seeds
    seen = []
    real = port_attention.flash_relpos_attention

    def recording(*args, **kw):
        seen.append(kw["dropout_rate"])
        return real(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_relpos_attention", recording)
    script, _ = _corpus(tmp_path)
    hp_path, save_dir = _write_hp(tmp_path, script, **CONFORMER)
    train_cli.main(["--hp_file", hp_path, "--device", "cpu", "--max_steps",
                    "2", "--set", "dropout=0.1", "--set",
                    "length_buckets=(256,)"])
    printed = capsys.readouterr().out
    assert "epoch 1 step 1 " in printed and "epoch 1 step 2 " in printed
    assert seen == [0.1] * (2 * SMALL["n_layer_decoder"])
    load_dir = os.path.join(save_dir, "epoch_1")
    assert "decoder_type = 'conformer'" in open(
        os.path.join(load_dir, "hparams.py")).read()
    out_dir = tmp_path / "gen"
    cli.main(["--load_name", load_dir, "--test_script", script, "--save",
              str(out_dir), "--max_frames", "64", "--device", "cpu"])
    for idx in range(6):
        mel = np.load(out_dir / f"{idx}.npy")
        assert mel.shape[1] == 16 and np.isfinite(mel).all()
