"""The Hopper design of K1/K1-d and K2, and with ``causal`` of K3
(csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu), on the CPU.

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
{0, 1, 65, T}. A model of both kernels' barrier protocol runs their CTAs'
producer and consumer warps over the stages' mbarriers: every attended
(row, key) pair is computed exactly once and every empty barrier counts
its init count of arrivals per phase; a variant whose warpgroup stops at
its own diagonal without releasing the CTA's later tiles fails it. Also:
the design rule of ``select_design`` over every mode, the entry points'
ctypes argument types against the C parameter lists in the sources, and
the sources' one copy of the dropout hash.
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
    flash_attention as jax_flash_attention, reference_attention)
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
                    bk=64, causal=False, wg_rows=64):
    """flash_fwd_sm90.cu's schedule in torch fp32: per (bq-row block, bh)
    two warpgroups of wg_rows rows, each over the key tiles of
    ``fwd_wg_tiles`` (up to ceil(k_len / bk); causal, to its diagonal),
    a running max in log2 units, the tile's P (times the keep scale) cast
    to v's dtype before P V, the row sum before dropout; o = acc / l,
    lse = (m + log2 l) ln 2."""
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
                    s = qb @ k[bi, hi, cols].float().T * scale_log2
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
                     seed=0, bkc=128, wg_keys=64, bq=64, causal=False):
    """flash_bwd_sm90.cu's schedule in torch fp32: per (bkc keys, bh) with
    two wg_keys halves, a block past k_len (causal, or past T_q) writing
    zeros, a loop over bq-row q tiles (``bwd_wg_tiles``; rows past T_q
    masked, causal keys past the row masked on the half's first, diagonal
    tile): P^T and dP^T, dS, dV and dK summed per key half, and each
    (q tile, key half)'s dQ partial added into an fp32 accumulator; dS and
    P keep cast to q's dtype before their products."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    dq = torch.zeros(b, h, t_q, d)
    dk = torch.zeros(b, h, t_k, d)
    dv = torch.zeros(b, h, t_k, d)
    for bi in range(b):
        klen = max(0, min(int(k_len[bi]), t_k))
        for hi in range(h):
            bh = bi * h + hi
            for k0 in range(0, t_k, bkc):
                if bwd_block_exits(k0, t_q, klen, causal):
                    continue                    # the zeros of dk and dv
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
                    dk[bi, hi, keys] = acc_dk
                    dv[bi, hi, keys] = acc_dv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _fwd_cta(q0, t_q, t_k, klen, causal, covered, release=True, rng=None):
    """flash_fwd_sm90.cu's CTA at query row q0: the producer's loads and
    each consumer warp's tiles, over the stage ring's mbarriers."""
    stages = _source_constant("flash_fwd_sm90", "STAGES")
    bk = _source_constant("flash_fwd_sm90", "BK")
    wg_rows = _source_constant("flash_fwd_sm90", "WG_ROWS")
    arrivals = _empty_arrivals("flash_fwd_sm90")
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(arrivals) for _ in range(stages)]
    n_tiles = fwd_wg_tiles(1, q0, t_q, klen, causal, bk, wg_rows)
    loaded = list(range(n_tiles))

    def producer():
        for kt in loaded:
            s, n = kt % stages, kt // stages
            if n > 0:
                yield "wait", empty[s], (n - 1) & 1
            yield "arrive", full[s], kt        # expect_tx + the TMA bytes

    def consumer(w, warp):
        rows = torch.arange(q0 + w * wg_rows + 16 * warp,
                            q0 + w * wg_rows + 16 * warp + 16)
        mine = fwd_wg_tiles(w, q0, t_q, klen, causal, bk, wg_rows)
        for kt in range(mine):
            s = kt % stages
            yield "wait", full[s], (kt // stages) & 1
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


def _bwd_cta(k0, t_q, t_k, klen, causal, covered, release=True, rng=None):
    """flash_bwd_sm90.cu's CTA at key k0, likewise: K and V once, then the
    q tiles from it0 through the ring; a block that exits loads nothing."""
    stages = _source_constant("flash_bwd_sm90", "STAGES")
    bq = _source_constant("flash_bwd_sm90", "BQ")
    wg_keys = _source_constant("flash_bwd_sm90", "WG_KEYS")
    arrivals = _empty_arrivals("flash_bwd_sm90")
    if bwd_block_exits(k0, t_q, klen, causal):
        return
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(arrivals) for _ in range(stages)]
    it0, _, n_qt = bwd_wg_tiles(0, k0, t_q, causal, bq, wg_keys)
    loaded = list(range(it0, n_qt))

    def producer():
        for j, it in enumerate(loaded):
            s, n = j % stages, j // stages
            if n > 0:
                yield "wait", empty[s], (n - 1) & 1
            yield "arrive", full[s], it

    def consumer(w, warp):
        keys = range(k0 + w * wg_keys + 16 * warp,
                     k0 + w * wg_keys + 16 * warp + 16)
        _, first, _ = bwd_wg_tiles(w, k0, t_q, causal, bq, wg_keys)
        skipped = range(it0, min(first, n_qt)) if release else ()
        for it in skipped:
            j = it - it0
            yield "wait", full[j % stages], (j // stages) & 1
            yield "arrive", empty[j % stages], it
        for it in range(first, n_qt):
            j = it - it0
            yield "wait", full[j % stages], (j // stages) & 1
            for c in keys:
                for r in range(it * bq, min(it * bq + bq, t_q)):
                    diag = causal and it == first
                    if c < klen and (not diag or c <= r):
                        covered[(r, c)] = covered.get((r, c), 0) + 1
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
    rng = random.Random(7)
    for t_q, t_k, klen in PROTOCOL_CASES:
        covered = {}
        if kernel == "fwd":
            for q0 in range(0, t_q, 128):
                _fwd_cta(q0, t_q, t_k, klen, causal, covered, rng=rng)
        else:
            for k0 in range(0, t_k, 128):
                _bwd_cta(k0, t_q, t_k, klen, causal, covered, rng=rng)
        assert set(covered) == _attended(t_q, t_k, klen, causal), \
            (t_q, t_k, klen)
        assert set(covered.values()) <= {1}, (t_q, t_k, klen)


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
    # modes K1/K2 do, so both masks of a mode expect the same design
    want = ("sm90" if dtype == torch.bfloat16 and not has_bias
            and d in (64, 96) and aligned else "simple")
    assert fa.select_design(dtype, has_bias, d, aligned) == want


def test_the_main_path_mode_takes_the_hopper_design():
    # FastSpeech 2's decoder and the AR decoder's causal self-attention:
    # d_model 384 over 4 heads, bf16 amp
    assert fa.select_design(torch.bfloat16, False, 384 // 4) == "sm90"
    assert fa.select_design(torch.float32, False, 96) == "simple"


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
