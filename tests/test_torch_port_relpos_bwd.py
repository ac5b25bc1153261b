"""The port's relative-position dropout forward (K4-d) and backward (K5) on
the CPU.

On a CPU tensor the wrappers take the kernels' plain versions, so these
tests hold those plain versions against the JAX package: all five
gradients of the ``tts_port::relpos_fwd`` op (whose CPU backward is the plain
K5, not autograd through the plain forward) against ``jax.grad`` of the
interpret-mode Pallas kernel and of ``reference_relpos_attention`` at the
block configurations of tests/test_flash_relpos.py (the two-kernel and the
fused TPU forms, and a padded T) at 5e-6; the dropout forward and its
gradients against the interpret-mode kernel on the same int32 seed. A
numpy emulation of the CUDA kernels' tiling (the skewed scatter of dS into
dA per branch, the dq_vs shift, the dP window clipped to [0, T)) is held
against the plain version. The CUDA kernels are held against the same
plain versions on the card by chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


GRAD_TOL = dict(rtol=0, atol=5e-6)
FWD_TOL = dict(rtol=0, atol=2e-6)
SEED = -123456789                   # an int32 whose uint32 bits wrap


def _data(t, b=2, h=2, d=8, seed=0, k_len=None):
    rs = np.random.RandomState(seed)
    qu, qv, k, v = (rs.randn(b, h, t, d).astype(np.float32)
                    for _ in range(4))
    p = rs.randn(h, t, d).astype(np.float32)
    kl = np.asarray(k_len if k_len is not None else [t, max(3, t // 2)],
                    np.int32)
    g = rs.randn(b, h, t, d).astype(np.float32)
    return (qu, qv, k, v, p), kl, g


def _port_grads(inputs, kl, g, rate=0.0, seed=0):
    """o and the five gradients of sum(o * g) through the tts_port::relpos_fwd op
    on the CPU."""
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    o, _ = fr.flash_relpos_attention(*xs, torch.as_tensor(kl),
                                     dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad((o * torch.as_tensor(g)).sum(), xs)
    return o.detach().numpy(), [x.numpy() for x in grads]


def _jax_grads(fn, inputs, g):
    def loss(*a):
        return jnp.sum(fn(*a) * jnp.asarray(g))
    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in inputs))


NAMES = ("dq_u", "dq_v", "dk", "dv", "dp")


@pytest.mark.parametrize("t,bq,bk", [(48, 16, 16), (37, 16, 32),
                                     (48, 16, 64),   # fused bwd (n_k == 1)
                                     (30, 32, 32)])  # fused, padded t
def test_plain_backward_matches_jax_grad(t, bq, bk):
    inputs, kl, g = _data(t, seed=1)
    _, ours = _port_grads(inputs, kl, g)
    jkl = jnp.asarray(kl)
    kernel = _jax_grads(lambda *a: jax_flash_relpos(
        *a, jkl, block_q=bq, block_k=bk, interpret=True), inputs, g)
    oracle = _jax_grads(lambda *a: reference_relpos_attention(*a, jkl),
                        inputs, g)
    for name, a, jk, jr in zip(NAMES, ours, kernel, oracle):
        np.testing.assert_allclose(a, np.asarray(jk), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(a, np.asarray(jr), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("t,bq,bk,k_len,seed", [
    (48, 16, 16, [48, 30], SEED),
    (37, 16, 32, [37, 1], 7),          # ragged T, a row with one key
    (30, 32, 32, [0, 30], 2 ** 31 - 1),  # fused, a row with no valid key
])
def test_dropout_forward_and_backward_match_interpret_kernel(t, bq, bk,
                                                             k_len, seed):
    inputs, kl, g = _data(t, seed=t, k_len=k_len)
    o, ours = _port_grads(inputs, kl, g, rate=0.1, seed=seed)
    jkl = jnp.asarray(kl)

    def kernel(*a):
        return jax_flash_relpos(*a, jkl, dropout_rate=0.1,
                                dropout_seed=jnp.int32(seed), block_q=bq,
                                block_k=bk, interpret=True)

    np.testing.assert_allclose(o, np.asarray(kernel(*inputs)), **FWD_TOL)
    for name, a, b in zip(NAMES, ours, _jax_grads(kernel, inputs, g)):
        np.testing.assert_allclose(a, np.asarray(b), err_msg=name,
                                   **GRAD_TOL)
    plain, _ = fr.flash_relpos_attention_fwd_reference(
        *(torch.as_tensor(x) for x in inputs), torch.as_tensor(kl),
        8 ** -0.5)
    assert not np.allclose(o, plain.numpy())      # dropout took effect


@pytest.mark.parametrize("shape", [(1, 1, 5, 5), (2, 3, 9, 9)])
def test_rel_shift_adjoint_is_the_transpose(shape):
    rs = np.random.RandomState(0)
    x, y = (torch.as_tensor(rs.randn(*shape)) for _ in range(2))
    lhs = (fr.rel_shift(x) * y).sum()
    rhs = (x * fr.rel_shift_adjoint(y)).sum()
    assert abs(float(lhs - rhs)) < 1e-12


def test_wrappers_on_cpu_take_plain_versions_and_launch_nothing():
    inputs, kl, g = _data(40, seed=3)
    q_u, q_v, k, v, p = (torch.as_tensor(x) for x in inputs)
    kl, do = torch.as_tensor(kl), torch.as_tensor(g)
    sm_scale = 8 ** -0.5
    counts = (fr.flash_relpos_attention_bwd_dq.launches,
              fr.flash_relpos_attention_bwd_dkdv.launches,
              fr.flash_relpos_attention.launches,
              fr.flash_relpos_attention.dropout_launches)
    o, lse = fr.flash_relpos_attention(q_u, q_v, k, v, p, kl,
                                       dropout_rate=0.1, dropout_seed=5)
    delta = fr.bwd_delta(o, do)
    args = (q_u, q_v, k, v, p, do, lse, delta, kl)
    kw = dict(sm_scale=sm_scale, dropout_rate=0.1, dropout_seed=5)
    dq = fr.flash_relpos_attention_bwd_dq(*args, **kw)
    dkdv = fr.flash_relpos_attention_bwd_dkdv(*args, **kw)
    ref = fr.flash_relpos_attention_bwd_reference(
        q_u, q_v, k, v, p, o, lse, do, kl, sm_scale, 0.1, 5)
    for got, want in zip((*dq, *dkdv), ref):
        assert torch.equal(got, want)
    assert counts == (fr.flash_relpos_attention_bwd_dq.launches,
                      fr.flash_relpos_attention_bwd_dkdv.launches,
                      fr.flash_relpos_attention.launches,
                      fr.flash_relpos_attention.dropout_launches)


@pytest.mark.parametrize("kind", ["do_dtype", "lse_shape", "delta_dtype"])
def test_backward_wrapper_rejects_what_the_kernel_cannot_take(kind):
    inputs, kl, g = _data(16, seed=4)
    q_u, q_v, k, v, p = (torch.as_tensor(x) for x in inputs)
    do = torch.as_tensor(g)
    lse = delta = torch.zeros(2, 2, 16)
    if kind == "do_dtype":
        do = do.bfloat16()
    elif kind == "lse_shape":
        lse = torch.zeros(2, 2, 15)
    else:
        delta = delta.double()
    with pytest.raises(ValueError):
        fr._check_relpos_bwd_inputs(q_u, q_v, k, v, p, do, lse, delta,
                                    torch.as_tensor(kl))


def test_both_relpos_kernels_take_the_hash_from_the_shared_header():
    csrc = Path(cuda_build.CSRC)
    for name in ("flash_relpos_fwd", "flash_relpos_bwd"):
        src = (csrc / f"{name}.cu").read_text()
        assert '#include "flash_common.cuh"' in src
        assert "keep_bit(uint32_t" not in src


# ---- a numpy emulation of K5's tiling ---------------------------------------

def _rows(x, row0, n):
    """Rows row0 .. row0+n-1 of x (T, d), zero outside [0, T)."""
    out = np.zeros((n, x.shape[1]))
    lo, hi = max(row0, 0), min(row0 + n, x.shape[0])
    if hi > lo:
        out[lo - row0:hi - row0] = x[lo:hi]
    return out


def _kernel_tiling(ds, q_v, p, k_len, bq, bk, window_offset=0):
    """numpy float64 emulation of the bias's backward in
    csrc/flash_relpos_bwd.cu: per (q tile, k tile below k_len) and used
    branch, dA[r][w] = dS[r][w + r - bq + 1] where that key lies in the
    tile and the branch, then dq_v (branch 1) or dq_vs (branch 2, added
    one row down) += dA P_win, and dP_win = dA^T Q_v (branch 2 one row
    down) added where the window rows lie in [0, T). ``window_offset``
    moves every window, for the test that a wrong window fails."""
    b, h, t, d = q_v.shape
    dq_v = np.zeros(q_v.shape)
    dq_vs = np.zeros(q_v.shape)
    dp = np.zeros(p.shape)
    r = np.arange(bq)[:, None]
    w = np.arange(bq + bk)[None, :]
    c = w + r - bq + 1
    for bi in range(b):
        for hi in range(h):
            for q0 in range(0, t, bq):
                tqv = _rows(q_v[bi, hi], q0, bq + 1)
                for k0 in range(0, int(k_len[bi]), bk):
                    tile = np.zeros((bq, bk))
                    n_r, n_c = min(bq, t - q0), min(bk, t - k0)
                    tile[:n_r, :n_c] = ds[bi, hi, q0:q0 + n_r, k0:k0 + n_c]
                    rel = (k0 + c) - (q0 + r)
                    for br in (0, 1):
                        used = (k0 <= q0 + bq - 1 if br == 0
                                else k0 + bk - 1 >= q0 + 2)
                        if not used:
                            continue
                        base = (t - bq + k0 - q0 if br == 0
                                else k0 - q0 - bq - 1) + window_offset
                        sel = (c >= 0) & (c < bk) & (
                            rel <= 0 if br == 0 else rel >= 2)
                        da = np.where(sel, tile[r, np.clip(c, 0, bk - 1)],
                                      0.0)
                        win = _rows(p[hi], base, bq + bk)
                        out = dq_v if br == 0 else dq_vs
                        out[bi, hi, q0:q0 + n_r] += (da @ win)[:n_r]
                        dwin = da.T @ tqv[br:br + bq]
                        lo, hi_ = max(base, 0), min(base + bq + bk, t)
                        if hi_ > lo:
                            dp[hi, lo:hi_] += dwin[lo - base:hi_ - base]
    dq_v[:, :, 1:] += dq_vs[:, :, :-1]
    return dq_v, dp


def _tiling_case(t, k_len, seed):
    inputs, kl, g = _data(t, seed=seed, k_len=k_len)
    q_u, q_v, k, v, p = (torch.as_tensor(x) for x in inputs)
    kl, do = torch.as_tensor(kl), torch.as_tensor(g)
    sm_scale = 8 ** -0.5
    o, lse = fr.flash_relpos_attention_fwd_reference(q_u, q_v, k, v, p, kl,
                                                     sm_scale)
    args = (q_u, q_v, k, v, p, do, lse, fr.bwd_delta(o, do), kl, sm_scale)
    ds, _ = fr._bwd_terms(*args, 0.0, 0)
    want_dqv = fr.flash_relpos_dq_reference(*args)[1].numpy()
    want_dp = fr.flash_relpos_dkdv_reference(*args)[2].numpy()
    return (ds.double().numpy(), inputs[1], inputs[4], kl.numpy(), want_dqv,
            want_dp)


@pytest.mark.parametrize("t,k_len,bq,bk", [
    (150, [150, 0], 32, 64),        # the kernels' own tiles, a ragged T
    (100, [1, 65], 16, 16),         # many tiles: every branch-skip case
    (64, [64, 63], 16, 32),
])
def test_kernel_tiling_matches_plain_version(t, k_len, bq, bk):
    ds, q_v, p, kl, want_dqv, want_dp = _tiling_case(t, k_len, t + bq)
    dq_v, dp = _kernel_tiling(ds, q_v, p, kl, bq, bk)
    np.testing.assert_allclose(dq_v, want_dqv, rtol=0, atol=2e-5)
    np.testing.assert_allclose(dp, want_dp, rtol=0, atol=2e-5)


@pytest.mark.parametrize("offset", [-1, 1])
def test_kernel_tiling_with_a_window_off_by_one_row_fails(offset):
    ds, q_v, p, kl, want_dqv, want_dp = _tiling_case(70, [70, 40], 5)
    dq_v, dp = _kernel_tiling(ds, q_v, p, kl, 32, 64, window_offset=offset)
    assert not np.allclose(dq_v, want_dqv, rtol=0, atol=1e-3)
    assert not np.allclose(dp, want_dp, rtol=0, atol=1e-3)
