"""The Hopper design of the relative-position attention, K4/K4-d and the
fused K5 (csrc/flash_relpos_fwd_sm90.cu, csrc/flash_relpos_bwd_sm90.cu), on
the CPU.

The kernels run only on the card (chip_smoke.py holds them against their
plain versions there). Here their schedules are emulated in torch and held
against the JAX package's Pallas kernel in interpret mode and ``jax.grad``
of it at 1e-5 of max|ref|: the position table E = [P; 0; P], the forward's
128-row blocks of two 64-row warpgroups, each key tile's 128-row window of
E as two 64-row slices with one query (q_v or its shifted copy) per half,
the skewed read A[r][c - r + 63], the online softmax in exp2 units and the
keep mask; the backward's 128-key blocks, its 64-row q tiles, the skewed
scatter of dS into window coordinates, dq_v's Q_vs half added one row
down, dE over each window and dP = dE[:T] + dE[T+1:]. A window one row
off fails. A model of both kernels' barrier protocol runs their producer
and consumer warps over the K/V (or q-tile) ring and the ring of E slices:
every attended (row, key) pair once, every empty phase complete with its
init count of arrivals for one tile or slice, no slice read after a warp
released it nor overwritten while read; a variant that releases a slice
after its first read fails. Also: the design rule, the entry points'
ctypes types against the C signatures, the shared headers, -lcuda, the
shared-memory budget of both sources.
"""

import ctypes
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_flash_sm90 import (
    _Barrier, _FakeLib, _c_params, _keep)
from transformer_tts_tpu.ops.flash_relpos import (
    flash_relpos_attention as jax_flash_relpos, reference_relpos_attention)
from transformer_tts_tpu_torch.ops import cuda_build
from transformer_tts_tpu_torch.ops import flash_relpos as fr


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE = 64                       # rows of a tile, a warpgroup and a slice
REL = 1e-5


def _data(t, b=4, h=1, d=16, seed=0):
    rs = np.random.RandomState(seed)
    q_u, q_v, k, v, g = (rs.randn(b, h, t, d).astype(np.float32)
                         for _ in range(5))
    p = rs.randn(h, t, d).astype(np.float32)
    return (q_u, q_v, k, v, p), g


def _rows(x, start, n):
    """Rows [start, start + n) of a 2-D tensor in fp32, zero outside it:
    what a TMA box at a signed row coordinate loads."""
    idx = torch.arange(start, start + n)
    ok = (idx >= 0) & (idx < x.shape[0])
    out = torch.zeros(n, x.shape[1])
    out[ok] = x[idx[ok]].float()
    return out


def _shifted(q_v):
    """q_vs[i] = q_v[i + 1], the last row zero (the box one row down)."""
    out = torch.zeros_like(q_v)
    out[..., :-1, :] = q_v[..., 1:, :]
    return out


# the skew: element (r, c) of a 64 x 64 tile reads window column c - r + 63
_R = torch.arange(TILE)
SKEW = _R[None, :] - _R[:, None] + TILE - 1


def fwd_slice_start(q0, t, n):
    """First row of E in the forward's slice n of the CTA at q0."""
    return t - q0 - 2 * TILE + TILE * n


def bwd_slice_start(k0, t, n):
    """First row of E in the backward's slice n of the CTA at k0."""
    return k0 + t + TILE - TILE * n


def emulate_forward(q_u, q_v, k, v, p, k_len, sm_scale, rate=0.0, seed=0,
                    window_shift=0, with_fp32=False):
    """flash_relpos_fwd_sm90.cu's schedule in torch fp32: per (128-row
    block, bh) two warpgroups of 64 rows; on key tile kt warpgroup w reads
    slices kt + lam + h (lam = 1 - w) of E for the halves h of its window,
    each half's product with Q_vs where its rows of E lie past T - 1 (k0 -
    q0w + 64h > 0), else with Q_v; S = Q_u K^T + A[r][c - r + 63]; the
    online softmax in log2 units, P (times keep) cast to v's dtype before
    P V, the row sum before dropout. ``window_shift`` moves every window
    by that many rows (a wrong kernel). ``with_fp32`` also returns o32:
    the lo part of P (P - bf16(P), cast again) through a second P V into
    an accumulator of its own, (acc + acc_lo) / l in fp32."""
    b, h, t, d = q_u.shape
    e = fr.position_table(p).float()
    q_vs = _shifted(q_v)
    o = torch.zeros(b, h, t, d)
    o32 = torch.zeros(b, h, t, d)
    lse = torch.full((b, h, t), NEG_INF)
    scale_log2 = sm_scale * LOG2E
    cols0 = torch.arange(TILE)
    for bi in range(b):
        klen = max(0, min(int(k_len[bi]), t))
        for hi in range(h):
            bh = bi * h + hi
            for q0 in range(0, t, 2 * TILE):
                for w in range(2):
                    r0 = q0 + w * TILE
                    if r0 >= t:
                        continue
                    lam = 1 - w
                    rows = torch.arange(r0, r0 + TILE)
                    qu, qv, qvs = (_rows(x[bi, hi], r0, TILE)
                                   for x in (q_u, q_v, q_vs))
                    m = torch.full((TILE,), NEG_INF)
                    l = torch.zeros(TILE)
                    acc = torch.zeros(TILE, d)
                    acc_lo = torch.zeros(TILE, d)
                    for kt in range(-(-klen // TILE)):
                        k0 = kt * TILE
                        halves = []
                        for hh in range(2):
                            win = _rows(e[hi], fwd_slice_start(
                                q0, t, kt + lam + hh) + window_shift, TILE)
                            qsel = qvs if k0 - r0 + TILE * hh > 0 else qv
                            halves.append(qsel @ win.T)
                        a = torch.cat(halves, dim=1)           # 64 x 128
                        kt_, vt = (_rows(x[bi, hi], k0, TILE)
                                   for x in (k, v))
                        s = (qu @ kt_.T + torch.gather(a, 1, SKEW)) \
                            * scale_log2
                        cols = k0 + cols0
                        valid = (cols < klen)[None, :].expand(TILE, TILE)
                        s = torch.where(valid, s, torch.tensor(NEG_INF))
                        m_new = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp2(m - m_new)
                        pr = torch.where(valid, torch.exp2(s - m_new[:, None]),
                                         torch.tensor(0.0))
                        l = l * alpha + pr.sum(dim=1)
                        if rate > 0.0:
                            pr = pr * _keep(seed, bh, rows, cols, rate)
                        p_hi = pr.to(v.dtype).float()
                        acc = acc * alpha[:, None] + p_hi @ vt
                        acc_lo = acc_lo * alpha[:, None] + (
                            (pr - p_hi).to(v.dtype).float() @ vt)
                        m = m_new
                    n = min(TILE, t - r0)
                    safe = torch.where(l > 0, l, torch.ones(()))
                    o[bi, hi, r0:r0 + n] = torch.where(
                        (l > 0)[:, None], acc / safe[:, None],
                        torch.zeros(()))[:n]
                    o32[bi, hi, r0:r0 + n] = torch.where(
                        (l > 0)[:, None], (acc + acc_lo) / safe[:, None],
                        torch.zeros(()))[:n]
                    lse[bi, hi, r0:r0 + n] = torch.where(
                        l > 0, (m + torch.log2(safe)) / LOG2E,
                        torch.tensor(NEG_INF))[:n]
    if with_fp32:
        return o.to(q_u.dtype), lse, o32
    return o.to(q_u.dtype), lse


def emulate_backward(q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale,
                     rate=0.0, seed=0):
    """flash_relpos_bwd_sm90.cu's schedule in torch fp32: per (128 keys,
    bh) two warpgroups of 64 keys (a block with no valid key computes
    nothing), a loop over 64-row q tiles; warpgroup w reads
    slices it + lam + 1 - h (lam = 1 - w) for its window's halves h.
    S^T with the skewed bias, P^T, dP^T (times keep) and dS^T; dV, dK per
    warpgroup; dq_u partials; dA[r][c - r + 63] = dS[r][c], dq_v partials
    over the halves of one query at a time, the Q_vs half's added one row
    down; dE_win = dA^T Qsel per half into rows m0 .. m0 + 127 of E inside
    the table; dP = dE[:T] + dE[T+1:]. dS and P keep cast to q_u's dtype
    before their products."""
    b, h, t, d = q_u.shape
    e = fr.position_table(p).float()
    q_vs = _shifted(q_v)
    dq_u = torch.zeros(b, h, t, d)
    dq_v = torch.zeros(b, h, t, d)
    dk = torch.zeros(b, h, t, d)
    dv = torch.zeros(b, h, t, d)
    de = torch.zeros(e.shape)
    for bi in range(b):
        klen = max(0, min(int(k_len[bi]), t))
        for hi in range(h):
            bh = bi * h + hi
            for k0 in range(0, t, 2 * TILE):
                if k0 >= klen:
                    continue                    # the zeros of dk and dv
                for w in range(2):
                    kw0 = k0 + w * TILE
                    if kw0 >= t:
                        continue                # keys past T: no rows out
                    lam = 1 - w
                    keys = torch.arange(kw0, kw0 + TILE)
                    kt_, vt = (_rows(x[bi, hi], kw0, TILE) for x in (k, v))
                    acc_dk = torch.zeros(TILE, d)
                    acc_dv = torch.zeros(TILE, d)
                    for it in range(-(-t // TILE)):
                        q0 = it * TILE
                        dlt = kw0 - q0
                        rows = torch.arange(q0, q0 + TILE)
                        in_t = rows < t
                        qu, qv, qvs, dot = (_rows(x[bi, hi], q0, TILE)
                                            for x in (q_u, q_v, q_vs, do))
                        lse_r = torch.where(in_t, _rows(
                            lse[bi, hi, :, None], q0, TILE)[:, 0], 0.0)
                        delta_r = _rows(delta[bi, hi, :, None], q0,
                                        TILE)[:, 0]
                        wins = [_rows(e[hi], bwd_slice_start(
                            k0, t, it + lam + 1 - hh), TILE)
                            for hh in range(2)]
                        sel = [dlt + TILE * hh > 0 for hh in range(2)]
                        qsel = [qvs if s else qv for s in sel]
                        a = torch.cat([qsel[hh] @ wins[hh].T
                                       for hh in range(2)], dim=1)
                        bias_t = torch.gather(a, 1, SKEW).T    # keys x rows
                        st = kt_ @ qu.T + bias_t
                        valid = (keys < klen)[:, None] & in_t[None, :]
                        pt = torch.where(valid, torch.exp2(
                            st * sm_scale * LOG2E - lse_r * LOG2E),
                            torch.tensor(0.0))
                        dpt = vt @ dot.T
                        pk = pt
                        if rate > 0.0:
                            keep = _keep(seed, bh, rows, keys, rate).T
                            dpt = dpt * keep
                            pk = pt * keep
                        dst = (pt * (dpt - delta_r) * sm_scale).to(
                            q_u.dtype).float()
                        pk = pk.to(q_u.dtype).float()
                        acc_dv += pk @ dot
                        acc_dk += dst @ qu
                        ds = dst.T                      # rows x keys
                        n = int(in_t.sum())
                        dq_u[bi, hi, q0:q0 + n] += (ds @ kt_)[:n]
                        da = torch.zeros(TILE, 2 * TILE)
                        da.scatter_(1, SKEW, ds)
                        segs = ([(0, 2)] if sel[0] == sel[1]
                                else [(0, 1), (1, 2)])
                        for h0, h1 in segs:
                            part = da[:, TILE * h0:TILE * h1] @ torch.cat(
                                wins[h0:h1])
                            down = int(sel[h0])
                            dst_rows = rows + down
                            ok = dst_rows < t
                            dq_v[bi, hi, dst_rows[ok]] += part[ok]
                        m0 = dlt + t - TILE
                        for hh in range(2):
                            dwin = da[:, TILE * hh:TILE * hh + TILE].T \
                                @ qsel[hh]
                            ms = m0 + TILE * hh + torch.arange(TILE)
                            ok = (ms >= 0) & (ms < e.shape[1])
                            de[hi, ms[ok]] += dwin[ok]
                    n = min(TILE, t - kw0)
                    dk[bi, hi, kw0:kw0 + n] = acc_dk[:n]
                    dv[bi, hi, kw0:kw0 + n] = acc_dv[:n]
    dp = fr.dp_from_table(de)
    return (dq_u.to(q_u.dtype), dq_v.to(q_v.dtype), dk.to(k.dtype),
            dv.to(v.dtype), dp.to(p.dtype))


def _assert_close_rel(got, want, rel=REL, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * peak, f"{name}: {err} > {rel} * {peak}"


def _jax_kernel(kl, rate, seed):
    jkl = jnp.asarray(kl)

    def call(*a):
        return jax_flash_relpos(*a, jkl, dropout_rate=rate,
                                dropout_seed=jnp.int32(seed), block_q=64,
                                block_k=64, interpret=True)
    return call


CASES = [(100, [100, 0, 1, 65]),     # T not a multiple of 64
         (200, [200, 0, 1, 65]),     # two forward blocks, ragged
         (192, [192, 65, 1, 0])]     # a multiple of 64


# ---- the position table ------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 5, 64, 100, 129])
def test_position_table_reproduces_rel_shift(t):
    rs = np.random.RandomState(t)
    q_v = torch.as_tensor(rs.randn(2, 3, t, 8))
    p = torch.as_tensor(rs.randn(3, t, 8))
    want = fr.rel_shift(q_v @ p.transpose(-1, -2))
    e = fr.position_table(p)
    assert e.shape == (3, 2 * t + 1, 8)
    assert torch.all(e[:, t] == 0)
    i = torch.arange(t)[:, None]
    j = torch.arange(t)[None, :]
    m = j - i + t - 1
    q_vs = _shifted(q_v)
    qsel = torch.where((m >= t)[None, None, :, :, None],
                       q_vs[:, :, :, None, :], q_v[:, :, :, None, :])
    got = (qsel * e[None][:, :, m]).sum(-1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_dp_from_table_is_the_adjoint_of_the_table():
    p = torch.randn(2, 7, 4, requires_grad=True)
    g = torch.randn(2, 15, 4)
    (grad,) = torch.autograd.grad((fr.position_table(p) * g).sum(), p)
    torch.testing.assert_close(fr.dp_from_table(g), grad)


# ---- the forward's schedule ----------------------------------------------

@pytest.mark.parametrize("t,k_len", CASES)
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_forward_schedule_matches_interpret_kernel(t, k_len, rate):
    inputs, _ = _data(t, seed=t)
    kl = np.asarray(k_len, np.int32)
    sm_scale = 16 ** -0.5
    o, lse = emulate_forward(*(torch.as_tensor(x) for x in inputs), kl,
                             sm_scale, rate, seed=-77)
    jo = _jax_kernel(kl, rate, -77)(*(jnp.asarray(x) for x in inputs))
    _assert_close_rel(o.numpy(), np.asarray(jo), name="o")
    ro, rlse = fr.flash_relpos_attention_fwd_reference(
        *(torch.as_tensor(x) for x in inputs), torch.as_tensor(kl),
        sm_scale, rate, -77)
    _assert_close_rel(lse.numpy()[kl > 0], rlse.numpy()[kl > 0], name="lse")
    assert (lse.numpy()[kl == 0] == np.float32(NEG_INF)).all()
    assert (o.numpy()[kl == 0] == 0).all()
    if rate == 0.0:
        ref = reference_relpos_attention(
            *(jnp.asarray(x) for x in inputs), jnp.asarray(kl))
        _assert_close_rel(o.numpy(), np.asarray(ref), name="reference")


@pytest.mark.parametrize("shift", [1, -1])
def test_forward_schedule_with_a_window_off_by_one_row_fails(shift):
    t = 100
    inputs, _ = _data(t, seed=1)
    kl = np.asarray([t, 80, 65, 30], np.int32)
    o, _ = emulate_forward(*(torch.as_tensor(x) for x in inputs), kl,
                           16 ** -0.5, window_shift=shift)
    ro, _ = fr.flash_relpos_attention_fwd_reference(
        *(torch.as_tensor(x) for x in inputs), torch.as_tensor(kl),
        16 ** -0.5)
    assert (o - ro).abs().max() > 1e-2 * ro.abs().max()


def test_forward_schedule_casts_p_before_pv():
    inputs, _ = _data(96, b=1, h=2, seed=4)
    xs = [torch.as_tensor(x).bfloat16() for x in inputs]
    kl = torch.tensor([90], dtype=torch.int32)
    o, _ = emulate_forward(*xs, kl, 16 ** -0.5)
    ro, _ = fr.flash_relpos_attention_fwd_reference(
        *(x.float() for x in xs), kl, 16 ** -0.5)
    err = (o.float() - ro).abs().max().item()
    assert 0 < err <= 2e-2 * ro.abs().max().item()


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_forward_schedule_gives_o32_over_both_parts_of_p(rate):
    # o32 (delta's output) within ~2^-16 of the unrounded P's output, where
    # o, P cast once as the TPU kernel does, is ~2^-9 off; o unchanged
    inputs, _ = _data(96, b=1, h=2, seed=4)
    xs = [torch.as_tensor(x).bfloat16() for x in inputs]
    kl = torch.tensor([90], dtype=torch.int32)
    o, lse, o32 = emulate_forward(*xs, kl, 16 ** -0.5, rate, seed=-77,
                                  with_fp32=True)
    ro, _, ro32 = fr.flash_relpos_attention_fwd_reference(
        *xs, kl, 16 ** -0.5, rate, -77, with_fp32=True)
    assert o32.dtype == torch.float32 and ro32.dtype == torch.float32
    peak = ro32.abs().max().item()
    err = (o32 - ro32).abs().max().item()
    assert err <= 2 ** -14 * peak
    assert err * 16 < (o.float() - ro32).abs().max().item()
    assert torch.equal(o, emulate_forward(*xs, kl, 16 ** -0.5, rate,
                                          seed=-77)[0])


# ---- the fused backward's schedule ----------------------------------------

def _jax_grads(inputs, kl, g, rate, seed):
    kernel = _jax_kernel(kl, rate, seed)

    def loss(*a):
        return jnp.sum(kernel(*a) * jnp.asarray(g))
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in inputs))


@pytest.mark.parametrize("t,k_len", CASES)
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_fused_backward_schedule_matches_jax_grad(t, k_len, rate):
    inputs, g = _data(t, seed=2 * t + 1)
    kl = np.asarray(k_len, np.int32)
    sm_scale = 16 ** -0.5
    ref = _jax_grads(inputs, kl, g, rate, seed=13)
    xs = [torch.as_tensor(x) for x in inputs]
    do, klt = torch.as_tensor(g), torch.as_tensor(kl)
    o, lse = fr.flash_relpos_attention_fwd_reference(*xs, klt, sm_scale,
                                                     rate, 13)
    grads = emulate_backward(*xs, do, lse, fr.bwd_delta(o, do), klt,
                             sm_scale, rate, 13)
    for name, ours, theirs in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads,
                                  ref):
        _assert_close_rel(ours.numpy(), np.asarray(theirs), name=name)
    for grad in grads[2:4]:              # keys at or past k_len: exactly 0
        for b, n in enumerate(k_len):
            assert torch.all(grad[b, :, n:] == 0)


def test_fused_backward_wrapper_on_cpu_is_the_plain_pair():
    inputs, g = _data(40, b=2, h=2, seed=9)
    xs = [torch.as_tensor(x) for x in inputs]
    do = torch.as_tensor(g)
    kl = torch.tensor([40, 17], dtype=torch.int32)
    o, lse = fr.flash_relpos_attention_fwd_reference(*xs, kl, 0.25, 0.2, 5)
    delta = fr.bwd_delta(o, do)
    kw = dict(sm_scale=0.25, dropout_rate=0.2, dropout_seed=5)
    before = fr.flash_relpos_attention_bwd_sm90.launches
    got = fr.flash_relpos_attention_bwd_sm90(*xs, do, lse, delta, kl, **kw)
    want = fr.flash_relpos_attention_bwd_reference(*xs, o, lse, do, kl,
                                                   0.25, 0.2, 5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert fr.flash_relpos_attention_bwd_sm90.launches == before


# ---- the barrier protocol of both kernels, modelled ----------------------

def _constant(source: str, name: str) -> int:
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def _init_count(source: str, barrier: str) -> int:
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    return int(re.search(rf"mbar_init\(&{barrier}\[s\], (\d+)\)", text)
               .group(1))


_RELEASE_RANGE = re.compile(
    r"void release_range\(int t, int (\w+), int lam,\s*int& lo, int& hi\)"
    r"\s*\{\s*lo = ([^;]+);\s*hi = ([^;]+);\s*\}")


def _c_ternary(expr: str, names) -> str:
    """``cond ? a : b`` of integer names and + - == as a Python expression."""
    cond, a, b = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr.strip()).groups()
    for part in (cond, a, b):
        for token in re.findall(r"[A-Za-z_]\w*", part):
            assert token in names, f"unexpected name {token} in {expr}"
        assert re.fullmatch(r"[\w\s+\-=]+", part), expr
    return f"({a}) if ({cond}) else ({b})"


def release_rule(source: str, text: str = None):
    """The device function ``release_range`` of ``source``.cu as it is
    written there: its ``lo =`` and ``hi =`` expressions, parsed and
    evaluated, give the slices a warpgroup releases at the end of its tile
    t (``text`` stands in for the source, for a mutated copy)."""
    if text is None:
        text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    m = _RELEASE_RANGE.search(text)
    assert m, f"{source}: no release_range(t, n, lam, lo, hi) to model"
    n_name, lo, hi = m.groups()
    names = ("t", n_name, "lam")
    lo_f, hi_f = (eval(f"lambda t, {n_name}, lam: {_c_ternary(e, names)}")
                  for e in (lo, hi))
    return lambda t, n, lam: range(lo_f(t, n, lam), hi_f(t, n, lam) + 1)


def early_release_rule(source: str):
    """The source's rule with each slice released after the first tile
    that reads it (the one its K/V or q-tile stage is released with): the
    ``t + lam`` of both ends made ``t + lam + 1`` in the source's text."""
    text = (Path(cuda_build.CSRC) / f"{source}.cu").read_text()
    assert text.count("t + lam;") == 2
    return release_rule(source, text.replace("t + lam;", "t + lam + 1;"))


def _run(processes, rng, slots, released):
    """Steps each warp's program in a random order until all end; fails on
    a deadlock, on a read of a slot holding another slice than the one
    expected (overwritten while read), and on a read of a slice the
    reading warp has already released. Ops: ("wait", barrier, parity),
    ("arrive", barrier, tag), ("load", slot, slice), ("read", slot,
    slice, warp), ("release", slice, warp)."""
    pending = {i: next(p, None) for i, p in enumerate(processes)}
    pending = {i: op for i, op in pending.items() if op is not None}
    while pending:
        ready = [i for i, op in pending.items()
                 if op[0] != "wait" or op[1].passed(op[2])]
        assert ready, "deadlock: every warp waits on a barrier"
        i = rng.choice(ready)
        op = pending[i]
        if op[0] == "arrive":
            op[1].arrive(op[2])
        elif op[0] == "load":
            slots[op[1]] = op[2]
        elif op[0] == "read":
            _, slot, sl, warp = op
            assert slots.get(slot) == sl, \
                f"slot {slot} holds slice {slots.get(slot)}, not {sl}"
            assert (warp, sl) not in released, \
                f"warp {warp} reads slice {sl} after releasing it"
        elif op[0] == "release":
            released.add((op[2], op[1]))
        nxt = next(processes[i], None)
        if nxt is None:
            del pending[i]
        else:
            pending[i] = nxt


def _cta(kernel, start, t, klen, covered, rule=None, rng=None):
    """One CTA of flash_relpos_fwd_sm90.cu (``start`` its first query row)
    or flash_relpos_bwd_sm90.cu (its first key): the producer's loads into
    the stage ring and the slice ring, and each consumer warp's tiles,
    slice reads and releases by the source's own ``release_range`` (or
    ``rule``); the covered (row, key) pairs are counted."""
    source = f"flash_relpos_{kernel}_sm90"
    rule = rule or release_rule(source)
    stages = _constant(source, "STAGES")
    e_slots = _constant(source, "E_SLOTS")
    arrivals = _init_count(source, "empty")
    assert _init_count(source, "e_empty") == arrivals
    if kernel == "fwd":
        n_tiles = -(-klen // TILE)
    else:
        if start >= klen:
            return                              # the early exit
        n_tiles = -(-t // TILE)
    full = [_Barrier(1) for _ in range(stages)]
    empty = [_Barrier(arrivals) for _ in range(stages)]
    e_full = [_Barrier(1) for _ in range(e_slots)]
    e_empty = [_Barrier(arrivals) for _ in range(e_slots)]
    slots, released = {}, set()
    n_slices = n_tiles + 2 if n_tiles else 0

    def producer():
        nxt = 0
        for kt in range(n_tiles):
            s, n = kt % stages, kt // stages
            if n > 0:
                yield "wait", empty[s], (n - 1) & 1
            yield "arrive", full[s], kt
            while nxt <= kt + 2:
                slot, ne = nxt % e_slots, nxt // e_slots
                if ne > 0:
                    yield "wait", e_empty[slot], (ne - 1) & 1
                yield "load", slot, nxt
                yield "arrive", e_full[slot], nxt
                nxt += 1
        assert nxt == n_slices

    def consumer(w, warp):
        lam = 1 - w
        me = (w, warp)
        for kt in range(n_tiles):
            s = kt % stages
            yield "wait", full[s], (kt // stages) & 1
            for sl in (kt + lam, kt + lam + 1):
                yield "wait", e_full[sl % e_slots], (sl // e_slots) & 1
                yield "read", sl % e_slots, sl, me
            lanes = range(16 * warp, 16 * warp + 16)
            for a in lanes:
                for c in range(TILE):
                    if kernel == "fwd":
                        pair = (start + w * TILE + a, kt * TILE + c)
                    else:
                        pair = (kt * TILE + c, start + w * TILE + a)
                    if pair[0] < t and pair[1] < klen:
                        covered[pair] = covered.get(pair, 0) + 1
            for sl in (kt + lam, kt + lam + 1):
                yield "read", sl % e_slots, sl, me
            yield "arrive", empty[s], kt
            for sl in rule(kt, n_tiles, lam):
                if sl >= n_slices:
                    continue
                yield "wait", e_full[sl % e_slots], (sl // e_slots) & 1
                yield "release", sl, me
                yield "arrive", e_empty[sl % e_slots], sl

    warps = [consumer(w, warp) for w in range(2) for warp in range(4)]
    _run([producer(), *warps], rng or random.Random(0), slots, released)
    for ring, count in ((empty, n_tiles), (e_empty, n_slices)):
        for slot, bar in enumerate(ring):
            tags = [j for j in range(count) if j % len(ring) == slot]
            assert [set(p) for p in bar.phases] == [{j} for j in tags], \
                f"slot {slot}: phases {bar.phases} for {tags}"
            assert all(len(p) == arrivals for p in bar.phases)
            assert bar.tags == [], f"slot {slot}: an unfinished phase"


def _attended(t, klen):
    return {(r, c) for r in range(t) for c in range(min(klen, t))}


PROTOCOL_CASES = [(100, 100), (200, 65), (192, 192), (511, 300), (64, 1),
                  (130, 0), (1, 1), (257, 257)]


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_barrier_protocol_covers_each_pair_once(kernel):
    rng = random.Random(11)
    for t, klen in PROTOCOL_CASES:
        covered = {}
        for start in range(0, t, 2 * TILE):
            _cta(kernel, start, t, klen, covered, rng=rng)
        assert set(covered) == _attended(t, klen), (t, klen)
        assert set(covered.values()) <= {1}, (t, klen)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_barrier_protocol_fails_when_a_slice_is_released_early(kernel):
    rng = random.Random(3)
    for t, klen in PROTOCOL_CASES:            # the kernels' rule passes
        for start in range(0, t, 2 * TILE):
            _cta(kernel, start, t, klen, {}, rng=rng)
    with pytest.raises(AssertionError):
        for start in range(0, 511, 2 * TILE):
            _cta(kernel, start, 511, 511, {},
                 early_release_rule(f"flash_relpos_{kernel}_sm90"), rng)


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_release_rule_releases_every_slice_once_per_warpgroup(kernel):
    release_range = release_rule(f"flash_relpos_{kernel}_sm90")
    for n_tiles in range(1, 9):
        for lam in (0, 1):
            got = [sl for t in range(n_tiles)
                   for sl in release_range(t, n_tiles, lam)]
            assert got == list(range(n_tiles + 2))
            # after the last tile that reads it (tiles sl - lam - 1 and
            # sl - lam read slice sl)
            for t in range(n_tiles):
                for sl in release_range(t, n_tiles, lam):
                    assert t >= min(sl - lam, n_tiles - 1)


# ---- routine cases ---------------------------------------------------------

@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 96, True, "sm90"), (torch.bfloat16, 64, True, "sm90"),
    (torch.bfloat16, 32, True, "simple"), (torch.bfloat16, 96, False,
                                            "simple"),
    (torch.float32, 96, True, "simple"), (torch.float16, 96, True,
                                          "simple")])
def test_design_rule_of_the_relative_kernels(dtype, d, aligned, want):
    x = torch.zeros(2 * 4 * 8 * d + 8, dtype=dtype)
    base = x[1:] if not aligned else x[:-8]
    q = base[:2 * 4 * 8 * d].view(2, 4, 8, d)
    p = torch.zeros(4, 8, d, dtype=dtype)
    assert fr._design(q, q, q, q, p) == want


def test_the_conformer_mode_takes_the_hopper_design():
    # the conformer's decoder: d_model 384 over 4 heads, bf16 amp
    q = torch.zeros(2, 4, 16, 96, dtype=torch.bfloat16)
    p = torch.zeros(4, 16, 96, dtype=torch.bfloat16)
    assert fr._design(q, q, q, q, p) == "sm90"
    assert fr._design(q.float(), q.float(), q.float(), q.float(),
                      p.float()) == "simple"


@pytest.mark.parametrize("name,getter", [
    ("flash_relpos_fwd_sm90", "_sm90_fwd"),
    ("flash_relpos_bwd_sm90", "_sm90_bwd"),
    ("flash_relpos_fwd", "_kernel")])
def test_entry_point_argtypes_match_the_c_signature(name, getter,
                                                    monkeypatch):
    monkeypatch.setattr(cuda_build, "load", lambda n: _FakeLib(n))
    fn = getattr(fr, getter)()
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


@pytest.mark.parametrize("name", ["flash_relpos_fwd_sm90",
                                  "flash_relpos_bwd_sm90"])
def test_sources_take_the_hash_and_helpers_from_the_shared_headers(name):
    src = (Path(cuda_build.CSRC) / f"{name}.cu").read_text()
    assert '#include "flash_common.cuh"' in src
    assert '#include "flash_sm90.cuh"' in src
    assert "keep_bit(seed" in src                      # the dropout mask
    for constant in ("0x9E3779B9", "0x85EBCA6B", "0xC2B2AE35"):
        assert constant not in src                     # no second hash
    assert "WgmmaSS<" in src and "wgmma.mma_async" not in src
    assert "wgmma.mma_async" in (Path(cuda_build.CSRC)
                                 / "flash_sm90.cuh").read_text()


@pytest.mark.parametrize("name", ["flash_relpos_fwd_sm90",
                                  "flash_relpos_bwd_sm90"])
def test_sources_link_libcuda_for_their_tensor_maps(name):
    assert cuda_build.LINK_FLAGS[name] == ("-lcuda",)


@pytest.mark.parametrize("d", [64, 96])
def test_shared_memory_fits_a_block(d):
    # the sources' Geom, recomputed from their constants: both fit the
    # 232,448 bytes a block may have, with the stated rings
    chunks, row = d // 32, 64
    fwd = lambda n: _constant("flash_relpos_fwd_sm90", n)   # noqa: E731
    bwd = lambda n: _constant("flash_relpos_bwd_sm90", n)   # noqa: E731
    tile = chunks * TILE * row
    band = TILE * fwd("BAND_LD") * 4
    f = (6 * tile + 2 * fwd("STAGES") * tile + fwd("E_SLOTS") * tile
         + 2 * band + (1 + 2 * fwd("STAGES") + 2 * fwd("E_SLOTS")) * 8
         + 1024)
    kv = chunks * bwd("BKC") * row
    scr = max(TILE * bwd("BAND_LD") * 4, TILE * 2 * TILE * 2)
    b = (2 * kv + bwd("STAGES") * 4 * tile + bwd("E_SLOTS") * tile
         + 2 * scr + bwd("STAGES") * 2 * TILE * 4
         + (1 + 2 * bwd("STAGES") + 2 * bwd("E_SLOTS")) * 8 + 1024)
    assert f <= 232448 and b <= 232448
    if d == 96:
        assert (f, b) == (210024, 223320)
    assert fwd("BAND_LD") % 32 == 8 and bwd("BAND_LD") % 32 == 8
