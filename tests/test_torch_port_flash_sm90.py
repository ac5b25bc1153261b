"""The Hopper design of K1/K1-d and K2, with ``causal`` of K3 and with a
bias of K6 (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu), on the CPU.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there). Here their schedules are emulated in torch and held
against the JAX package's Pallas kernels in interpret mode: the forward's
128-row query blocks of two 64-row warpgroups, their key tiles (skipped at
or past k_len; causal, ended at each warpgroup's diagonal tile, the only
one masked by c <= r), the online rescale in exp2 units and P cast to the
value dtype before P.V, at 1e-5 of max|ref|; the fused backward's 128-key
blocks of two 64-key halves, its 64-row q tiles (causal, from each half's
diagonal tile), dk and dv summed per key block and dq as the sum of the
per-(q tile, 64 keys) partials, against ``jax.grad`` at k_len in
{0, 1, 65, T}. With a bias (K6) the same schedules add it to S before
the scale and write dbias from the transposed dS, each element once (the
zeros of a key block past k_len included), against the interpret-mode
``flash_attention_with_bias`` and ``jax.grad`` of it at 1e-5 of each
tensor's max|ref|. A model of both kernels' barrier protocol runs their
CTAs' producer and consumer warps over the stages' mbarriers: every
attended (row, key) pair is computed exactly once and every empty barrier
counts its init count of arrivals per phase; a variant whose warpgroup
stops at its own diagonal without releasing the CTA's later tiles fails
it; with the bias, each stage's bias tile is read while the stage holds
it, and the backward's dbias staging tile is rewritten only after its TMA
store has read it (a variant without that wait fails). Also: the design
rule of ``select_design`` over every mode, the entry points' ctypes
argument types against the C parameter lists in the sources, the sources'
one copy of the dropout hash, and the bias tiles' 128-byte swizzle (a
permutation in each period, conflict-free ldmatrix/stmatrix rows that land
on the accumulator's fragment).
"""

import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.ops.flash_attention import (
    flash_attention as jax_flash_attention, flash_attention_with_bias as
    jax_flash_bias, reference_attention)
from transformer_tts_tpu_torch.ops import cuda_build
from transformer_tts_tpu_torch.ops import flash_attention as fa

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def _qkv(seed, b, h, t_q, t_k, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (t_q, t_k, t_k))


def _keep(seed, bh, rows, cols, rate):
    """The keep scale (B*H index bh) over global rows x cols, fp32."""
    keep = fa.keep_bits(seed, torch.tensor(bh, dtype=torch.int64),
                        rows[:, None], cols[None, :], rate)
    return keep.float() / (1.0 - rate)


def fwd_wg_tiles(w, q0, t_q, klen, causal, bk=64, wg_rows=64):
    """``wg_tiles`` of flash_fwd_sm90.cu: the key tiles consumer
    warpgroup w of the CTA at query row q0 computes -- every tile below
    k_len; causal, only up to its diagonal tile and the tile of row
    T_q - 1. The CTA loads warpgroup 1's count."""
    n = -(-klen // bk)
    if not causal:
        return n
    rows_end = min(q0 + (w + 1) * wg_rows, t_q)
    return min(n, -(-rows_end // bk))


def fwd_limits(rows, r0, kt, klen, causal, bk=64):
    """The key bound each of ``rows`` of the warpgroup whose rows start at
    r0 (a multiple of bk) sees on key tile kt: k_len, and on the
    warpgroup's diagonal tile with ``causal`` also c <= row (the kernel's
    ``lim``)."""
    if causal and kt == r0 // bk:
        return torch.clamp(rows + 1, max=klen)
    return torch.full_like(rows, klen)


def emulate_forward(q, k, v, k_len, sm_scale, rate=0.0, seed=0, bq=128,
                    bk=64, causal=False, wg_rows=64, bias=None):
    """flash_fwd_sm90.cu's schedule in torch fp32: per (bq-row block, bh)
    two warpgroups of wg_rows rows, each over the key tiles of
    ``fwd_wg_tiles`` (up to ceil(k_len / bk); causal, to its diagonal),
    the tile's ``bias`` (if any) added to S before the scale, a running
    max in log2 units, the tile's P (times the keep scale) cast to v's
    dtype before P V, the row sum before dropout; o = acc / l, lse = (m +
    log2 l) ln 2."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    o = torch.zeros(b, h, t_q, d)
    lse = torch.full((b, h, t_q), NEG_INF)
    scale_log2 = sm_scale * LOG2E
    for bi in range(b):
        klen = max(0, min(int(k_len[bi]), t_k))
        for hi in range(h):
            bh = bi * h + hi
            for q0, w in ((q0, w) for q0 in range(0, t_q, bq)
                          for w in range(bq // wg_rows)):
                if q0 + w * wg_rows >= t_q:
                    continue                    # a warpgroup past T_q
                rows = torch.arange(q0 + w * wg_rows,
                                    min(q0 + (w + 1) * wg_rows, t_q))
                qb = q[bi, hi, rows].float()
                m = torch.full((len(rows),), NEG_INF)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), d)
                for kt in range(fwd_wg_tiles(w, q0, t_q, klen, causal, bk,
                                             wg_rows)):
                    cols = torch.arange(kt * bk, min(kt * bk + bk, t_k))
                    s = qb @ k[bi, hi, cols].float().T
                    if bias is not None:
                        s = s + bias[bi, hi][rows][:, cols].float()
                    s = s * scale_log2
                    lim = fwd_limits(rows, q0 + w * wg_rows, kt, klen,
                                     causal, bk)
                    valid = cols[None, :] < lim[:, None]
                    s = torch.where(valid, s, torch.tensor(NEG_INF))
                    m_new = torch.maximum(m, s.max(dim=1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(s - m_new[:, None]),
                                    torch.tensor(0.0))
                    l = l * alpha + p.sum(dim=1)
                    if rate > 0.0:
                        p = p * _keep(seed, bh, rows, cols, rate)
                    acc = acc * alpha[:, None] + (
                        p.to(v.dtype).float() @ v[bi, hi, cols].float())
                    m = m_new
                safe = torch.where(l > 0, l, torch.ones(()))
                o[bi, hi, rows] = torch.where(
                    (l > 0)[:, None], acc / safe[:, None], torch.zeros(()))
                lse[bi, hi, rows] = torch.where(
                    l > 0, (m + torch.log2(safe)) / LOG2E,
                    torch.tensor(NEG_INF))
    return o.to(q.dtype), lse


def bwd_block_exits(k0, t_q, klen, causal):
    """flash_bwd_sm90.cu's early exit: a key block with no valid key, or
    (causal) none that a row reaches, writes zeros and stops."""
    return k0 >= klen or (causal and k0 >= t_q)


def bwd_wg_tiles(w, k0, t_q, causal, bq=64, wg_keys=64):
    """(it0, first, n_qt) of flash_bwd_sm90.cu for consumer warpgroup w of
    the key block at k0: the CTA loads q tiles it0..n_qt-1 (causal, from
    the tile holding row k0), the warpgroup computes first..n_qt-1 (its
    diagonal tile on) and releases the tiles before ``first`` unread."""
    n_qt = -(-t_q // bq)
    if not causal:
        return 0, 0, n_qt
    return k0 // bq, (k0 + w * wg_keys) // bq, n_qt


def emulate_backward(q, k, v, do, lse, delta, k_len, sm_scale, rate=0.0,
                     seed=0, bkc=128, wg_keys=64, bq=64, causal=False,
                     bias=None):
    """flash_bwd_sm90.cu's schedule in torch fp32: per (bkc keys, bh) with
    two wg_keys halves, a block past k_len (causal, or past T_q) writing
    zeros, a loop over bq-row q tiles (``bwd_wg_tiles``; rows past T_q
    masked, causal keys past the row masked on the half's first, diagonal
    tile): S^T with the transposed ``bias`` (if any) added before the
    scale, P^T and dP^T, dS, dV and dK summed per key half, and each
    (q tile, key half)'s dQ partial added into an fp32 accumulator; dS and
    P keep cast to q's dtype before their products. With a bias, dbias is
    each (q tile, key half)'s dS^T transposed, and the zeros of a block
    past k_len; every element must be written exactly once. Returns (dq,
    dk, dv[, dbias])."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    dq = torch.zeros(b, h, t_q, d)
    dk = torch.zeros(b, h, t_k, d)
    dv = torch.zeros(b, h, t_k, d)
    dbias = torch.full((b, h, t_q, t_k), float("nan"))
    writes = torch.zeros(b, h, t_q, t_k, dtype=torch.int32)
    for bi in range(b):
        klen = max(0, min(int(k_len[bi]), t_k))
        for hi in range(h):
            bh = bi * h + hi
            for k0 in range(0, t_k, bkc):
                if bwd_block_exits(k0, t_q, klen, causal):
                    # the zeros of dk and dv (and of dbias's slab)
                    dbias[bi, hi, :, k0:k0 + bkc] = 0.0
                    writes[bi, hi, :, k0:k0 + bkc] += 1
                    continue
                for w, kh in enumerate(range(k0, min(k0 + bkc, t_k),
                                             wg_keys)):
                    keys = torch.arange(kh, min(kh + wg_keys, t_k))
                    kt, vt = (x[bi, hi, keys].float() for x in (k, v))
                    acc_dk = torch.zeros(len(keys), d)
                    acc_dv = torch.zeros(len(keys), d)
                    _, first, n_qt = bwd_wg_tiles(w, k0, t_q, causal, bq,
                                                  wg_keys)
                    for it in range(first, n_qt):
                        q0 = it * bq
                        rows = torch.arange(q0, min(q0 + bq, t_q))
                        qt = q[bi, hi, rows].float()
                        dot = do[bi, hi, rows].float()
                        st = kt @ qt.T                  # keys x rows
                        if bias is not None:
                            st = st + bias[bi, hi][rows][:, keys].float().T
                        dpt = vt @ dot.T
                        valid = (keys < klen)[:, None]
                        if causal and it == first:      # the diagonal tile
                            valid = valid & (keys[:, None] <= rows[None, :])
                        pt = torch.where(
                            valid, torch.exp2(st * sm_scale * LOG2E
                                              - lse[bi, hi, rows] * LOG2E),
                            torch.tensor(0.0))
                        pk = pt
                        if rate > 0.0:
                            keep = _keep(seed, bh, rows, keys, rate).T
                            dpt = dpt * keep
                            pk = pt * keep
                        dst = pt * (dpt - delta[bi, hi, rows]) * sm_scale
                        dst = dst.to(q.dtype).float()
                        pk = pk.to(q.dtype).float()
                        acc_dv += pk @ dot
                        acc_dk += dst @ qt
                        dq[bi, hi, rows] += dst.T @ kt   # the partial
                        dbias[bi, hi, rows[0]:rows[-1] + 1,
                              keys[0]:keys[-1] + 1] = dst.T
                        writes[bi, hi, rows[0]:rows[-1] + 1,
                               keys[0]:keys[-1] + 1] += 1
                    dk[bi, hi, keys] = acc_dk
                    dv[bi, hi, keys] = acc_dv
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias is None:
        return grads
    assert (writes == 1).all(), "a dbias element written other than once"
    return (*grads, dbias.to(bias.dtype))


def _assert_close_rel(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * peak


@pytest.mark.parametrize("t_q,t_k,k_len", [
    (200, 200, [200, 0, 1, 65]),          # two q blocks, ragged key tiles
    (130, 300, [300, 129, 64, 0]),        # T_q != T_k
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_forward_schedule_matches_interpret_kernel(t_q, t_k, k_len, rate):
    q, k, v = _qkv(t_q + t_k, 4, 1, t_q, t_k, 32)
    kl = np.asarray(k_len, np.int32)
    sm_scale = 32 ** -0.5
    o, lse = emulate_forward(*(torch.as_tensor(x) for x in (q, k, v)), kl,
                             sm_scale, rate, seed=-77)
    args = [jnp.asarray(x) for x in (q, k, v, kl)]
    jo = jax_flash_attention(*args, dropout_rate=rate, dropout_seed=-77,
                             block_q=32, block_k=32, interpret=True)
    _assert_close_rel(o.numpy(), np.asarray(jo), 1e-5)
    ro, rlse = fa.flash_attention_fwd_reference(
        *(torch.as_tensor(x) for x in (q, k, v, kl)), sm_scale, rate, -77)
    _assert_close_rel(lse.numpy()[kl > 0], rlse.numpy()[kl > 0], 1e-5)
    assert (lse.numpy()[kl == 0] == np.float32(NEG_INF)).all()
    assert (o.numpy()[kl == 0] == 0).all()
    if rate == 0.0:
        ref = reference_attention(*args)
        _assert_close_rel(o.numpy(), np.asarray(ref), 1e-5)


def test_forward_schedule_casts_p_before_pv():
    # in bf16 the emulation rounds P like the kernel: it equals the plain
    # version (which casts the normalised P) only to bf16's precision, and
    # differs from an fp32 P.V
    q, k, v = (torch.as_tensor(x).bfloat16() for x in _qkv(3, 1, 2, 64,
                                                            96, 32))
    kl = torch.tensor([90], dtype=torch.int32)
    o, _ = emulate_forward(q, k, v, kl, 32 ** -0.5, bk=64)
    ro, _ = fa.flash_attention_fwd_reference(q.float(), k.float(),
                                             v.float(), kl, 32 ** -0.5)
    err = (o.float() - ro).abs().max().item()
    assert 0 < err <= 2e-2 * ro.abs().max().item()


def _jax_grads(q, k, v, kl, w, rate, seed):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, jnp.asarray(kl), dropout_rate=rate,
                                dropout_seed=seed, block_q=32, block_k=32,
                                interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("t_q,t_k", [(150, 150), (70, 200)])
def test_fused_backward_schedule_matches_jax_grad(t_q, t_k, rate):
    t = t_k
    k_len = [0, 1, 65, t]
    q, k, v = _qkv(5 + t_q, 4, 1, t_q, t_k, 32)
    kl = np.asarray(k_len, np.int32)
    w = np.random.RandomState(2).randn(4, 1, t_q, 32).astype(np.float32)
    sm_scale = 32 ** -0.5
    ref = _jax_grads(q, k, v, kl, w, rate, seed=13)
    qt, kt, vt, do = (torch.as_tensor(x) for x in (q, k, v, w))
    klt = torch.as_tensor(kl)
    o, lse = fa.flash_attention_fwd_reference(qt, kt, vt, klt, sm_scale,
                                              rate, 13)
    grads = emulate_backward(qt, kt, vt, do, lse, fa.bwd_delta(o, do), klt,
                             sm_scale, rate, 13)
    for ours, theirs in zip(grads, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-4)
    for g in grads[1:]:                  # keys at or past k_len: exactly 0
        for b, n in enumerate(k_len):
            assert torch.all(g[b, :, n:] == 0)


def test_fused_backward_wrapper_on_cpu_is_the_plain_pair():
    q, k, v = (torch.as_tensor(x) for x in _qkv(9, 2, 2, 40, 40, 16))
    kl = torch.tensor([40, 17], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.2, 5)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(1))
    delta = fa.bwd_delta(o, do)
    kw = dict(sm_scale=0.25, dropout_rate=0.2, dropout_seed=5)
    before = fa.flash_attention_bwd_sm90.launches
    got = fa.flash_attention_bwd_sm90(q, k, v, do, lse, delta, kl, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, kl, 0.25,
                                            0.2, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.flash_attention_bwd_sm90.launches == before


# ---- the bias (K6) ---------------------------------------------------------

def _bias(seed, b, h, t_q, t_k):
    return (2 * np.random.RandomState(seed).randn(b, h, t_q, t_k)).astype(
        np.float32)


BIAS_CASES = [  # T_q != T_k both ways, T_k a multiple of 8 (the TMA rule)
    (200, 136, [136, 0, 1, 65]),
    (136, 200, [200, 65, 1, 0]),
]


@pytest.mark.parametrize("t_q,t_k,k_len", BIAS_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_bias_forward_schedule_matches_interpret_kernel(t_q, t_k, k_len,
                                                        rate):
    q, k, v = _qkv(7 + t_q, 4, 1, t_q, t_k, 32)
    bias = _bias(t_k, 4, 1, t_q, t_k)
    kl = np.asarray(k_len, np.int32)
    sm_scale = 32 ** -0.5
    o, lse = emulate_forward(*(torch.as_tensor(x) for x in (q, k, v)), kl,
                             sm_scale, rate, seed=-77,
                             bias=torch.as_tensor(bias))
    jo = jax_flash_bias(*(jnp.asarray(x) for x in (q, k, v, bias, kl)),
                        dropout_rate=rate, dropout_seed=jnp.int32(-77),
                        block_q=32, block_k=32, interpret=True)
    _assert_close_rel(o.numpy(), np.asarray(jo), 1e-5)
    ro, rlse = fa.flash_attention_fwd_reference(
        *(torch.as_tensor(x) for x in (q, k, v, kl)), sm_scale, rate, -77,
        bias=torch.as_tensor(bias))
    _assert_close_rel(lse.numpy()[kl > 0], rlse.numpy()[kl > 0], 1e-5)
    assert (lse.numpy()[kl == 0] == np.float32(NEG_INF)).all()
    assert (o.numpy()[kl == 0] == 0).all()


def _jax_bias_grads(q, k, v, bias, kl, w, rate, seed):
    def loss(q, k, v, bias):
        o = jax_flash_bias(q, k, v, bias, jnp.asarray(kl), dropout_rate=rate,
                           dropout_seed=jnp.int32(seed), block_q=32,
                           block_k=32, interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, k, v, bias)))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t_q,t_k,k_len", BIAS_CASES)
def test_bias_fused_backward_schedule_matches_jax_grad(t_q, t_k, k_len,
                                                       rate):
    q, k, v = _qkv(9 + t_k, 4, 1, t_q, t_k, 32)
    bias = _bias(t_q, 4, 1, t_q, t_k)
    kl = np.asarray(k_len, np.int32)
    w = np.random.RandomState(4).randn(4, 1, t_q, 32).astype(np.float32)
    sm_scale = 32 ** -0.5
    ref = _jax_bias_grads(q, k, v, bias, kl, w, rate, seed=17)
    qt, kt, vt, bt, do = (torch.as_tensor(x) for x in (q, k, v, bias, w))
    klt = torch.as_tensor(kl)
    o, lse = fa.flash_attention_fwd_reference(qt, kt, vt, klt, sm_scale,
                                              rate, 17, bias=bt)
    grads = emulate_backward(qt, kt, vt, do, lse, fa.bwd_delta(o, do), klt,
                             sm_scale, rate, 17, bias=bt)
    for ours, theirs in zip(grads, ref):
        _assert_close_rel(ours.numpy(), np.asarray(theirs), 1e-5)
    for b, n in enumerate(k_len):         # keys at or past k_len: exactly 0
        for g in grads[1:3]:
            assert torch.all(g[b, :, n:] == 0)
        assert torch.all(grads[3][b, :, :, n:] == 0)
    assert grads[3][0].abs().max() > 0


def test_bias_fused_backward_wrapper_on_cpu_is_the_plain_pair():
    q, k, v = (torch.as_tensor(x) for x in _qkv(29, 2, 2, 40, 48, 16))
    bias = torch.as_tensor(_bias(29, 2, 2, 40, 48))
    kl = torch.tensor([48, 17], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.2, 5,
                                              bias=bias)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    kw = dict(sm_scale=0.25, dropout_rate=0.2, dropout_seed=5)
    before = fa.flash_attention_bwd_sm90.bias_launches
    got = fa.flash_attention_bwd_sm90(q, k, v, do, lse, fa.bwd_delta(o, do),
                                      kl, bias=bias, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, kl, 0.25,
                                            0.2, 5, bias=bias)
    assert len(got) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fa.flash_attention_bwd_sm90.bias_launches == before


# ---- causal (K3) --------------------------------------------------------

@pytest.mark.parametrize("t_q,t_k,k_len", [
    (200, 200, [200, 0, 1, 65]),          # two q blocks, ragged key tiles
    (130, 300, [300, 129, 65, 0]),        # T_q < T_k
    (300, 130, [130, 1, 65, 0]),          # T_q > T_k
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_causal_forward_schedule_matches_interpret_kernel(t_q, t_k, k_len,
                                                          rate):
    q, k, v = _qkv(3 * t_q + t_k, 4, 1, t_q, t_k, 32)
    kl = np.asarray(k_len, np.int32)
    sm_scale = 32 ** -0.5
    o, lse = emulate_forward(*(torch.as_tensor(x) for x in (q, k, v)), kl,
                             sm_scale, rate, seed=-77, causal=True)
    args = [jnp.asarray(x) for x in (q, k, v, kl)]
    jo = jax_flash_attention(*args, causal=True, dropout_rate=rate,
                             dropout_seed=-77, block_q=32, block_k=32,
                             interpret=True)
    _assert_close_rel(o.numpy(), np.asarray(jo), 1e-5)
    ro, rlse = fa.flash_attention_fwd_reference(
        *(torch.as_tensor(x) for x in (q, k, v, kl)), sm_scale, rate, -77,
        causal=True)
    _assert_close_rel(lse.numpy()[kl > 0], rlse.numpy()[kl > 0], 1e-5)
    assert (lse.numpy()[kl == 0] == np.float32(NEG_INF)).all()
    assert (o.numpy()[kl == 0] == 0).all()
    if rate == 0.0:
        ref = reference_attention(*args, causal=True)
        _assert_close_rel(o.numpy(), np.asarray(ref), 1e-5)


def _jax_causal_grads(q, k, v, kl, w, rate, seed):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, jnp.asarray(kl), causal=True,
                                dropout_rate=rate, dropout_seed=seed,
                                block_q=32, block_k=32, interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("t_q,t_k", [(150, 150), (70, 200), (200, 70)])
def test_causal_fused_backward_schedule_matches_jax_grad(t_q, t_k, rate):
    k_len = [t_k, 0, 1, 65]
    q, k, v = _qkv(11 + t_q + 2 * t_k, 4, 1, t_q, t_k, 32)
    kl = np.asarray(k_len, np.int32)
    w = np.random.RandomState(3).randn(4, 1, t_q, 32).astype(np.float32)
    sm_scale = 32 ** -0.5
    ref = _jax_causal_grads(q, k, v, kl, w, rate, seed=21)
    qt, kt, vt, do = (torch.as_tensor(x) for x in (q, k, v, w))
    klt = torch.as_tensor(kl)
    o, lse = fa.flash_attention_fwd_reference(qt, kt, vt, klt, sm_scale,
                                              rate, 21, causal=True)
    grads = emulate_backward(qt, kt, vt, do, lse, fa.bwd_delta(o, do), klt,
                             sm_scale, rate, 21, causal=True)
    for ours, theirs in zip(grads, ref):
        _assert_close_rel(ours.numpy(), np.asarray(theirs), 1e-5)
    for g in grads[1:]:       # keys past k_len, or past every row: 0
        for b, n in enumerate(k_len):
            assert torch.all(g[b, :, min(n, t_q):] == 0)


def test_causal_fused_backward_wrapper_on_cpu_is_the_plain_pair():
    q, k, v = (torch.as_tensor(x) for x in _qkv(19, 2, 2, 40, 50, 16))
    kl = torch.tensor([50, 17], dtype=torch.int32)
    o, lse = fa.flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.2, 5,
                                              causal=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(2))
    delta = fa.bwd_delta(o, do)
    kw = dict(sm_scale=0.25, dropout_rate=0.2, dropout_seed=5)
    before = (fa.flash_attention_bwd_sm90.launches,
              fa.flash_attention_bwd_sm90.causal_launches)
    got = fa.flash_attention_bwd_sm90(q, k, v, do, lse, delta, kl,
                                      causal=True, **kw)
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, kl, 0.25,
                                            0.2, 5, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (fa.flash_attention_bwd_sm90.launches,
            fa.flash_attention_bwd_sm90.causal_launches) == before


# ---- the barrier protocol of both kernels, modelled ----------------------

def _source_constant(source: str, name: str) -> int:
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _empty_arrivals(source: str) -> int:
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    return int(re.search(r"mbar_init\(&empty\[s\], (\d+)\)", text)
               .group(1))


class _Barrier:
    """An mbarrier: ``count`` arrivals complete a phase; a wait on parity
    P passes once the phase of parity P has completed (the parity of the
    phase in progress differs). Keeps the tags of each phase's arrivals."""

    def __init__(self, count):
        self.count, self.phase, self.tags, self.phases = count, 0, [], []

    def arrive(self, tag):
        self.tags.append(tag)
        if len(self.tags) == self.count:
            self.phases.append(self.tags)
            self.phase, self.tags = self.phase + 1, []

    def passed(self, parity):
        return (self.phase & 1) != parity


def _run_cta(processes, rng):
    """Steps each warp's program (a generator of ("wait", barrier,
    parity) and ("arrive", barrier, tag)) in a random order until all end;
    fails on a deadlock."""
    pending = {i: next(p, None) for i, p in enumerate(processes)}
    pending = {i: op for i, op in pending.items() if op is not None}
    while pending:
        ready = [i for i, (kind, bar, arg) in pending.items()
                 if kind == "arrive" or bar.passed(arg)]
        assert ready, "deadlock: every warp waits on a barrier"
        i = rng.choice(ready)
        kind, bar, arg = pending[i]
        if kind == "arrive":
            bar.arrive(arg)
        op = next(processes[i], None)
        if op is None:
            del pending[i]
        else:
            pending[i] = op


def _check_stages(empty, loaded, stages, arrivals):
    """Every tile the producer loaded completed its stage's empty phase
    with exactly ``arrivals`` arrivals, all for that tile, and no
    arrival is left over."""
    for s, bar in enumerate(empty):
        tiles = [t for j, t in enumerate(loaded) if j % stages == s]
        assert [set(p) for p in bar.phases] == [{t} for t in tiles], \
            f"stage {s}: phases {bar.phases} for tiles {tiles}"
        assert all(len(p) == arrivals for p in bar.phases)
        assert bar.tags == [], f"stage {s}: {len(bar.tags)} arrivals of " \
                               f"an unfinished phase"


class _Slots:
    """What each stage's bias slot holds: the producer's TMA load fills it
    before it arrives on the stage's full barrier; a consumer's read, from
    its full wait to its release, must find the tile it waited for there
    (the yield between lets other warps run while it reads)."""

    def __init__(self, stages):
        self.held = [None] * stages

    def load(self, s, tile):
        yield "arrive", _NOOP, None
        self.held[s] = tile

    def read(self, s, tile):
        for _ in range(2):
            assert self.held[s] == tile, \
                f"stage {s} holds bias tile {self.held[s]}, read for {tile}"
            yield "arrive", _NOOP, None


class _Noop:
    def arrive(self, tag):
        pass


_NOOP = _Noop()


def _fwd_cta(q0, t_q, t_k, klen, causal, covered, release=True, rng=None,
             bias=False):
    """flash_fwd_sm90.cu's CTA at query row q0: the producer's loads and
    each consumer warp's tiles, over the stage ring's mbarriers; with
    ``bias`` each stage also carries its bias tile, read by the consumers
    before they release the stage."""
    stages = _source_constant("flash_fwd_sm90", "STAGES")
    bk = _source_constant("flash_fwd_sm90", "BK")
    wg_rows = _source_constant("flash_fwd_sm90", "WG_ROWS")
    arrivals = _empty_arrivals("flash_fwd_sm90")
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(arrivals) for _ in range(stages)]
    slots = _Slots(stages)
    n_tiles = fwd_wg_tiles(1, q0, t_q, klen, causal, bk, wg_rows)
    loaded = list(range(n_tiles))

    def producer():
        for kt in loaded:
            s, n = kt % stages, kt // stages
            if n > 0:
                yield "wait", empty[s], (n - 1) & 1
            if bias:
                yield from slots.load(s, kt)   # the bias box, same barrier
            yield "arrive", full[s], kt        # expect_tx + the TMA bytes

    def consumer(w, warp):
        rows = torch.arange(q0 + w * wg_rows + 16 * warp,
                            q0 + w * wg_rows + 16 * warp + 16)
        mine = fwd_wg_tiles(w, q0, t_q, klen, causal, bk, wg_rows)
        for kt in range(mine):
            s = kt % stages
            yield "wait", full[s], (kt // stages) & 1
            if bias:
                yield from slots.read(s, kt)
            lim = fwd_limits(rows, q0 + w * wg_rows, kt, klen, causal, bk)
            for r, n in zip(rows.tolist(), lim.tolist()):
                for c in range(kt * bk, min(kt * bk + bk, t_k)):
                    if r < t_q and c < n:
                        covered[(r, c)] = covered.get((r, c), 0) + 1
            yield "arrive", empty[s], kt
        for kt in range(mine, n_tiles if release else mine):
            s = kt % stages
            yield "wait", full[s], (kt // stages) & 1
            yield "arrive", empty[s], kt

    warps = [consumer(w, warp) for w in range(2) for warp in range(4)]
    _run_cta([producer(), *warps], rng or random.Random(0))
    _check_stages(empty, loaded, stages, arrivals)


def _bwd_cta(k0, t_q, t_k, klen, causal, covered, release=True, rng=None,
             dbias=None, wait_store=True):
    """flash_bwd_sm90.cu's CTA at key k0, likewise: K and V once, then the
    q tiles from it0 through the ring; a block that exits loads nothing.
    With ``dbias`` (a dict counting the writes of each (row, key)) each
    stage also carries the two bias halves, and each warpgroup stages
    every tile's dS in its own tile, stored by its thread 0 after a named
    barrier; before the next tile's writes that thread waits for the
    store to have read the tile (``wait_store``), then the barrier. A block
    that exits writes its T_q x 128 slab of zeros."""
    stages = _source_constant("flash_bwd_sm90", "STAGES")
    bq = _source_constant("flash_bwd_sm90", "BQ")
    wg_keys = _source_constant("flash_bwd_sm90", "WG_KEYS")
    arrivals = _empty_arrivals("flash_bwd_sm90")
    bias = dbias is not None

    def store(rows, keys):
        for r in rows:
            for c in keys:
                if r < t_q and c < t_k:
                    dbias[(r, c)] = dbias.get((r, c), 0) + 1

    if bwd_block_exits(k0, t_q, klen, causal):
        if bias:
            store(range(t_q), range(k0, k0 + 2 * wg_keys))
        return
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(arrivals) for _ in range(stages)]
    slots = _Slots(stages)
    named = [_Barrier(4) for _ in range(2)]     # each wg's bar.sync
    pending = [False, False]                    # a store reads its staging
    it0, _, n_qt = bwd_wg_tiles(0, k0, t_q, causal, bq, wg_keys)
    loaded = list(range(it0, n_qt))

    def producer():
        for j, it in enumerate(loaded):
            s, n = j % stages, j // stages
            if n > 0:
                yield "wait", empty[s], (n - 1) & 1
            if bias:
                yield from slots.load(s, it)   # both halves, same barrier
            yield "arrive", full[s], it

    def sync(w, count):
        yield "arrive", named[w], None
        yield "wait", named[w], count & 1

    def stage_dbias(w, warp, syncs, it):
        """The dS staging of one tile: returns the named barriers used."""
        if warp == 0 and wait_store:
            pending[w] = False                  # cp.async.bulk.wait_group.read
        yield from sync(w, syncs)
        assert not pending[w], "the dbias staging tile was rewritten while " \
                               "its store read it"
        yield from sync(w, syncs + 1)
        if warp == 0:                           # thread 0: the TMA store
            pending[w] = True
            store(range(it * bq, it * bq + bq),
                  range(k0 + w * wg_keys, k0 + (w + 1) * wg_keys))

    def consumer(w, warp):
        keys = range(k0 + w * wg_keys + 16 * warp,
                     k0 + w * wg_keys + 16 * warp + 16)
        _, first, _ = bwd_wg_tiles(w, k0, t_q, causal, bq, wg_keys)
        skipped = range(it0, min(first, n_qt)) if release else ()
        for it in skipped:
            j = it - it0
            yield "wait", full[j % stages], (j // stages) & 1
            yield "arrive", empty[j % stages], it
        syncs = 0
        for it in range(first, n_qt):
            j = it - it0
            yield "wait", full[j % stages], (j // stages) & 1
            if bias:
                yield from slots.read(j % stages, it)
            for c in keys:
                for r in range(it * bq, min(it * bq + bq, t_q)):
                    diag = causal and it == first
                    if c < klen and (not diag or c <= r):
                        covered[(r, c)] = covered.get((r, c), 0) + 1
            if bias:
                yield from stage_dbias(w, warp, syncs, it)
                syncs += 2
            yield "arrive", empty[j % stages], it

    warps = [consumer(w, warp) for w in range(2) for warp in range(4)]
    _run_cta([producer(), *warps], rng or random.Random(0))
    _check_stages(empty, loaded, stages, arrivals)


def _attended(t_q, t_k, klen, causal):
    return {(r, c) for r in range(t_q) for c in range(min(klen, t_k))
            if not causal or c <= r}


PROTOCOL_CASES = [  # (T_q, T_k, k_len)
    (300, 700, 700), (300, 700, 650), (700, 300, 300), (700, 300, 65),
    (511, 200, 1), (129, 200, 128), (64, 65, 65), (200, 130, 0),
    (257, 511, 511),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_barrier_protocol_covers_each_pair_once(kernel, causal):
    # non-causal also with the bias stage (K6 is non-causal): the bias
    # tile read while its stage holds it, and in the backward every dbias
    # element written exactly once, the slabs of blocks past k_len included
    rng = random.Random(7)
    for t_q, t_k, klen in PROTOCOL_CASES:
        for bias in (False,) if causal else (False, True):
            covered = {}
            dbias = {} if bias and kernel == "bwd" else None
            if kernel == "fwd":
                for q0 in range(0, t_q, 128):
                    _fwd_cta(q0, t_q, t_k, klen, causal, covered, rng=rng,
                             bias=bias)
            else:
                for k0 in range(0, t_k, 128):
                    _bwd_cta(k0, t_q, t_k, klen, causal, covered, rng=rng,
                             dbias=dbias)
            assert set(covered) == _attended(t_q, t_k, klen, causal), \
                (t_q, t_k, klen, bias)
            assert set(covered.values()) <= {1}, (t_q, t_k, klen, bias)
            if dbias is not None:
                assert set(dbias) == {(r, c) for r in range(t_q)
                                      for c in range(t_k)}, (t_q, t_k, klen)
                assert set(dbias.values()) == {1}, (t_q, t_k, klen)


def test_barrier_protocol_fails_a_dbias_staging_rewritten_too_early():
    # thread 0 must wait for the last TMA store to have read the staging
    # tile before the barrier that lets its warps rewrite it
    for k0 in range(0, 300, 128):
        _bwd_cta(k0, 300, 300, 300, False, {}, dbias={})
    with pytest.raises(AssertionError, match="rewritten"):
        for seed in range(5):
            for k0 in range(0, 300, 128):
                _bwd_cta(k0, 300, 300, 300, False, {}, dbias={},
                         wait_store=False, rng=random.Random(seed))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_barrier_protocol_fails_without_the_release_past_the_diagonal(
        kernel):
    # a warpgroup that stops at its own diagonal and never arrives for the
    # CTA's other tiles leaves a stage's phase short (or the producer
    # waiting forever): the model must catch it in some CTA
    cta = _fwd_cta if kernel == "fwd" else _bwd_cta
    starts = range(0, 511, 128)
    for t_q, t_k, klen in [(511, 511, 511), (300, 700, 700)]:
        for start in starts:
            cta(start, t_q, t_k, klen, True, {})        # the kernel: passes
    with pytest.raises(AssertionError):
        for start in starts:
            cta(start, 511, 511, 511, True, {}, release=False)


def test_causal_schedules_stop_at_the_diagonal():
    # the forward's warpgroup rows end on its diagonal tile, the
    # backward's keys begin on it: no tile past it is loaded for nothing
    assert [fwd_wg_tiles(w, 256, 511, 511, True) for w in (0, 1)] == [5, 6]
    assert [fwd_wg_tiles(w, 384, 511, 511, True) for w in (0, 1)] == [7, 8]
    assert [fwd_wg_tiles(w, 384, 400, 511, True) for w in (0, 1)] == [7, 7]
    assert fwd_wg_tiles(1, 384, 511, 100, True) == 2          # k_len first
    assert [bwd_wg_tiles(w, 256, 511, True) for w in (0, 1)] == [
        (4, 4, 8), (4, 5, 8)]
    assert bwd_block_exits(384, 300, 700, True)               # past T_q
    assert not bwd_block_exits(384, 300, 700, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("has_bias", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 96, 128])
@pytest.mark.parametrize("aligned", [True, False])
def test_design_rule_over_every_mode(dtype, causal, has_bias, d, aligned):
    # the rule takes no mask: K3 (causal) takes the Hopper design in the
    # modes K1/K2 do, so both masks of a mode expect the same design; a
    # bias (K6) takes it too where its rows are TMA boxes, T_k a multiple
    # of 8 (a row stride of 2 T_k bytes), else the simple design
    hopper = dtype == torch.bfloat16 and d in (64, 96) and aligned
    assert fa.select_design(dtype, has_bias, d, aligned) == (
        "sm90" if hopper else "simple")
    for t_k in (1024, 1000, 700, 1023):
        q, k, v, bias = _held(dtype, d, 8, t_k, has_bias, aligned)
        want = "sm90" if hopper and (t_k % 8 == 0 or not has_bias) \
            else "simple"
        assert fa._design(q, k, v, bias) == want, t_k


def _held(dtype, d, t_q, t_k, has_bias, aligned):
    """q, k, v and the bias (or None) on the CPU, at 16-byte aligned data
    pointers or, not ``aligned``, one element past them."""
    def make(*shape):
        n = int(np.prod(shape))
        flat = torch.zeros(n + 1, dtype=dtype)
        assert flat.data_ptr() % 16 == 0
        return flat[int(not aligned):][:n].view(shape)
    return (make(1, 1, t_q, d), make(1, 1, t_k, d), make(1, 1, t_k, d),
            make(1, 1, t_q, t_k) if has_bias else None)


def test_the_main_path_mode_takes_the_hopper_design():
    # FastSpeech 2's decoder and the AR decoder's causal self-attention:
    # d_model 384 over 4 heads, bf16 amp; and the conformer step's route 2
    # (its relative bias built in memory, T = 1024; at T_k = 700 the
    # bias's rows are no TMA boxes)
    assert fa.select_design(torch.bfloat16, False, 384 // 4) == "sm90"
    assert fa.select_design(torch.float32, False, 96) == "simple"
    assert fa._design(*_held(torch.bfloat16, 96, 1024, 1024, True,
                             True)) == "sm90"
    assert fa._design(*_held(torch.bfloat16, 96, 300, 700, True,
                             True)) == "simple"


def _c_params(source: str, name: str):
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    match = re.search(rf"\bint {name}\(([^)]*)\)\s*{{", text)
    assert match, f"no entry point {name} in {source}.cu"
    return [p.strip() for p in match.group(1).split(",")]


class _FakeLib:
    def __init__(self, name):
        setattr(self, name, type("Fn", (), {"argtypes": None,
                                             "restype": None})())


@pytest.mark.parametrize("name,getter", [("flash_fwd_sm90", "_sm90_fwd"),
                                         ("flash_bwd_sm90", "_sm90_bwd"),
                                         ("flash_attention_fwd",
                                          "_fwd_kernel")])
def test_entry_point_argtypes_match_the_c_signature(name, getter,
                                                    monkeypatch):
    import ctypes
    monkeypatch.setattr(cuda_build, "load", lambda n: _FakeLib(n))
    fn = getattr(fa, getter)()
    params = _c_params(name, name)
    assert len(fn.argtypes) == len(params)
    for ctype, param in zip(fn.argtypes, params):
        if "*" in param:
            assert ctype is ctypes.c_void_p, param     # no 32-bit pointer
        elif param.startswith("float"):
            assert ctype is ctypes.c_float, param
        elif param.startswith("unsigned"):
            assert ctype is ctypes.c_uint32, param
        else:
            assert param.startswith("int ") and ctype is ctypes.c_int, param
    assert fn.restype is ctypes.c_int
    # the causal flag, an int after the seed, as the wrappers pass it
    at = params.index("int causal")
    assert params[at - 1] == "unsigned int seed"
    assert fn.argtypes[at] is ctypes.c_int
    # the nullable bias after v, and the backward's dbias after dv, where
    # the wrappers pass them (as the simple kernels take them)
    assert params[3] == "const void* bias"
    if name == "flash_bwd_sm90":
        assert params[10:12] == ["void* dv", "void* dbias"]


@pytest.mark.parametrize("name", ["flash_fwd_sm90", "flash_bwd_sm90"])
def test_sources_take_the_hash_from_the_shared_header(name):
    src = (Path(cuda_build.CSRC) / f"{name}.cu").read_text()
    assert '#include "flash_common.cuh"' in src
    assert '#include "flash_sm90.cuh"' in src
    assert "keep_bit(seed" in src                      # the dropout mask
    for constant in ("0x9E3779B9", "0x85EBCA6B", "0xC2B2AE35"):
        assert constant not in src                     # no second hash
    assert "wgmma" in (Path(cuda_build.CSRC) / "flash_sm90.cuh").read_text()


def test_sources_link_libcuda_for_their_tensor_maps():
    assert cuda_build.LINK_FLAGS["flash_fwd_sm90"] == ("-lcuda",)
    assert cuda_build.LINK_FLAGS["flash_bwd_sm90"] == ("-lcuda",)


def test_swizzle_of_the_ds_store_is_a_permutation_in_each_period():
    # the dS^T store's address rule (sm90::swizzled_offset) must match the
    # 64-byte swizzle: 16-byte pieces permuted within each 512-byte period
    def swizzled(rows, row, col):
        off = (col // 32) * rows * 64 + row * 64 + (col % 32) * 2
        return off ^ ((off >> 3) & 0x30)
    offs = [swizzled(64, r, c) for r in range(64) for c in range(0, 64, 2)]
    assert sorted(offs) == list(range(0, 64 * 64 * 2, 4))
    for r in range(8):                 # one row's pieces stay in its row
        row = {swizzled(64, r, c) // 64 for c in range(0, 32, 2)}
        assert row == {r}
    header = (Path(cuda_build.CSRC) / "flash_sm90.cuh").read_text()
    assert "off ^ ((off >> 3) & 0x30)" in header


def _swizzled128(row, col):
    """sm90::swizzled128_offset: the bias tiles' 128-byte swizzle."""
    off = row * 128 + col * 2
    return off ^ ((off >> 3) & 0x70)


def test_swizzle_of_the_bias_tile_is_a_permutation_in_each_period():
    # the 16-byte pieces of each 1024-byte period (8 rows of 64 bf16 keys)
    # are permuted within it, each row's pieces staying in its row: the
    # layout of a TMA box with CU_TENSOR_MAP_SWIZZLE_128B
    header = (Path(cuda_build.CSRC) / "flash_sm90.cuh").read_text()
    assert "off ^ ((off >> 3) & 0x70)" in header
    for rows in (64, 128):                     # the backward's, the forward's
        offs = [_swizzled128(r, c) for r in range(rows)
                for c in range(0, 64, 8)]
        assert sorted(offs) == list(range(0, rows * 128, 16))
        for r in range(rows):
            assert {_swizzled128(r, c) // 128 for c in range(0, 64, 8)} \
                == {r}
            assert {_swizzled128(r, c) // 1024 for c in range(0, 64, 8)} \
                == {r // 8}


def _c_int(expr: str, names):
    """A C expression over non-negative ints (+ - * / % and parentheses)
    as a Python function of ``names``."""
    expr = " ".join(expr.split())
    assert re.fullmatch(r"[\w\s+\-*/%()]+", expr), expr
    for token in re.findall(r"[A-Za-z_]\w*", expr):
        assert token in names, f"unexpected name {token} in {expr}"
    return eval(f"lambda {', '.join(names)}: {expr.replace('/', '//')}")


def _source(kernel: str) -> str:
    return (Path(cuda_build.CSRC) / f"flash_{kernel}_sm90.cu").read_text()


def lane_address_rule(kernel, text=None):
    """The address each lane gives the kernels' ldmatrix (forward: the
    128-row bias tile, rows are query rows) or ldmatrix/stmatrix.trans
    (backward: a warpgroup's 64 x 64 bias or dbias tile, rows are query
    rows, columns its keys), as the source writes it: its ``bias_row``
    (forward) or ``bias_q`` and ``bias_col`` (backward) and the arguments
    of ``swizzled128_offset`` in the calls, parsed and evaluated. Returns
    f(w, warp, kk, lane) -> (row, col) of the lane's 16-byte row
    (``text`` stands in for the source, for a mutated copy)."""
    text = _source(kernel) if text is None else text

    def const(name):
        return _c_int(re.search(rf"const int {name} =([^;]+);", text)
                      .group(1), ("w", "WG_ROWS", "warp", "lane"))

    if kernel == "fwd":
        wg_rows = int(re.search(r"constexpr int WG_ROWS = (\d+);", text)
                      .group(1))
        row = const("bias_row")
        calls = re.findall(r"ldsm_x4\(bias_frag\[kk\],\s*b_tile \+ "
                           r"swizzled128_offset\(bias_row,\s*(.+?)\)\);",
                           text, re.S)
        assert len(calls) == 1, calls
        col = _c_int(calls[0], ("kk", "lane"))
        return lambda w, warp, kk, lane: (
            row(w, wg_rows, warp, lane), col(kk, lane))
    bias_q, bias_col = const("bias_q"), const("bias_col")
    calls = re.findall(r"(?:ldsm_x4_trans\(bias_frag\[kk\],|stsm_x4_trans\()"
                       r"\s*\w+ \+ swizzled128_offset\((.+?),\s*(\w+)\)",
                       text, re.S)
    assert len(calls) == 2 and calls[0] == calls[1], calls   # read, write
    row = _c_int(calls[0][0], ("kk", "bias_q"))
    col = _c_int(calls[0][1], ("bias_col",))
    return lambda w, warp, kk, lane: (
        row(kk, bias_q(w, 0, warp, lane)), col(bias_col(w, 0, warp, lane)))


def check_bias_fragments(kernel, text=None):
    """Each 8-lane phase of an x4 access reads eight 16-byte rows that
    fill the 32 banks once; and the elements the lanes receive (plain: row
    l/4 of the matrix, columns 2(l%4)+e; .trans: row 2(l%4)+e, column
    l/4) are the accumulator fragment's -- the forward's S (row 16 warp +
    l/4 + 8h, key 8nb + 2(l%4) + e), the backward's S^T (key 16 warp + l/4
    + 8h, q row 8nb + 2(l%4) + e) -- for register r of step kk, h = r % 2
    and nb = 2kk + r // 2; the dbias stmatrix.trans writes dS back to the
    same places."""
    address = lane_address_rule(kernel, text)
    for w in range(2 if kernel == "fwd" else 1):
        for warp in range(4):
            seen = set()
            for kk in range(4):
                addr = [address(w, warp, kk, lane) for lane in range(32)]
                for m in range(4):
                    banks = {(_swizzled128(*addr[8 * m + i]) % 128) // 16
                             for i in range(8)}
                    assert banks == set(range(8))
                for lane in range(32):
                    for m in range(4):
                        for e in range(2):
                            if kernel == "fwd":
                                row, col = addr[8 * m + lane // 4]
                                got = (row, col + 2 * (lane % 4) + e)
                                want = (w * 64 + 16 * warp + lane // 4
                                        + 8 * (m % 2),
                                        8 * (2 * kk + m // 2)
                                        + 2 * (lane % 4) + e)
                            else:
                                row, col = addr[8 * m + 2 * (lane % 4) + e]
                                got = (row, col + lane // 4)
                                want = (8 * (2 * kk + m // 2)
                                        + 2 * (lane % 4) + e,
                                        16 * warp + lane // 4 + 8 * (m % 2))
                            assert got == want, (kernel, warp, kk, lane, m)
                            seen.add(got)
            rows = 16 if kernel == "fwd" else 64
            assert len(seen) == rows * (64 if kernel == "fwd" else 16)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_bias_tile_fragments_are_conflict_free_and_land_on_the_accumulator(
        kernel):
    # the lane addresses as the sources write them
    check_bias_fragments(kernel)


@pytest.mark.parametrize("kernel, old, new", [
    ("fwd", "8 * ((lane / 8) % 2) +", "8 * (lane / 16) +"),
    ("fwd", "(2 * kk + lane / 16) * 8", "(2 * kk + (lane / 8) % 2) * 8"),
    ("bwd", "8 * (lane / 16) + lane % 8;", "8 * ((lane / 8) % 2) + lane % 8;"),
])
def test_bias_fragment_check_fails_a_swapped_lane_term(kernel, old, new):
    # the check reads the sources: a lane term swapped in a copy fails it
    text = _source(kernel)
    assert text.count(old) == 1
    with pytest.raises(AssertionError):
        check_bias_fragments(kernel, text.replace(old, new))
