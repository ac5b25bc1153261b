"""The port's causal flash attention (K3) on the CPU.

On a CPU tensor the wrappers take the kernels' plain versions, so these
tests hold K3's plain forward and backward (``causal=True``) against the
JAX package's Pallas kernels in interpret mode, at 1e-5 in fp32: the
forward at rates 0 and 0.1 (the keep mask is the same hash bit for bit,
so the dropped outputs agree too), the backward against ``jax.grad`` of
the interpret-mode kernel. Beside them a numpy emulation of the CUDA
kernels' tile ranges (the forward's and dq's key-tile bound, dk/dv's
first q tile) must cover every attended (row, key) pair exactly once.
The CUDA kernels are held against the same plain versions on the card by
chip_smoke.py.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.ops.flash_attention import (
    _flash_fwd, flash_attention as jax_flash_attention, reference_attention)
from transformer_tts_tpu_torch.ops import cuda_build
from transformer_tts_tpu_torch.ops.flash_attention import (
    bwd_delta, flash_attention, flash_attention_bwd, flash_attention_bwd_dkdv,
    flash_attention_bwd_dq, flash_attention_bwd_reference,
    flash_attention_fwd_reference)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-5, atol=1e-5)
RATE_SEED = 2 ** 31 - 5

# (t_q, t_k, d, k_len): T not a multiple of any tile, T_q != T_k both
# ways, k_len in {1, 65, T}
CASES = [
    (90, 90, 16, [1, 65]),
    (90, 90, 16, [90, 65]),
    (70, 100, 16, [65, 100]),
    (100, 70, 32, [1, 70]),
]


def _qkv(seed, b, h, t_q, t_k, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (t_q, t_k, t_k))


def _torch(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t_q,t_k,d,k_len", CASES)
def test_causal_forward_matches_interpret_kernel(t_q, t_k, d, k_len, rate):
    q, k, v = _qkv(t_q + 3 * t_k + d, 2, 2, t_q, t_k, d)
    kl = np.asarray(k_len, np.int32)
    sm_scale = d ** -0.5
    args = [jnp.asarray(x) for x in (q, k, v, kl)]
    jo = jax_flash_attention(*args, causal=True, dropout_rate=rate,
                             dropout_seed=RATE_SEED, block_q=16, block_k=16,
                             interpret=True)
    _, jlse = _flash_fwd(*args, causal=True, sm_scale=sm_scale,
                         dropout_rate=rate, seed=jnp.int32(RATE_SEED),
                         block_q=16, block_k=16, interpret=True)
    o, lse = flash_attention_fwd_reference(*_torch(q, k, v, kl), sm_scale,
                                           rate, RATE_SEED, causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :, :t_q],
                               **TOL)
    if rate == 0.0:       # and the plain jnp oracle of the same semantics
        ref = reference_attention(*args, causal=True, sm_scale=sm_scale)
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), **TOL)
    else:
        plain, _ = flash_attention_fwd_reference(
            *_torch(q, k, v, kl), sm_scale, causal=True)
        assert not torch.allclose(o, plain)        # dropout took effect


def test_causal_forward_differs_from_prefix_only():
    q, k, v = _qkv(1, 1, 2, 40, 40, 16)
    kl = np.asarray([33], np.int32)
    causal, _ = flash_attention_fwd_reference(*_torch(q, k, v, kl), 0.25,
                                              causal=True)
    full, _ = flash_attention_fwd_reference(*_torch(q, k, v, kl), 0.25)
    # the last valid row sees every valid key either way; the first does not
    assert torch.allclose(causal[:, :, 32], full[:, :, 32], atol=1e-6)
    assert not torch.allclose(causal[:, :, 0], full[:, :, 0])
    # row 0 sees key 0 alone: its output is v[0]
    assert torch.allclose(causal[:, :, 0], torch.as_tensor(v)[:, :, 0],
                          atol=1e-6)


def _jax_grads(q, k, v, kl, w, rate):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, jnp.asarray(kl), causal=True,
                                dropout_rate=rate, dropout_seed=RATE_SEED,
                                block_q=16, block_k=16, interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("t_q,t_k,d,k_len", CASES)
def test_causal_gradients_match_jax_grad(t_q, t_k, d, k_len, rate):
    q, k, v = _qkv(7 + t_q + t_k, 2, 2, t_q, t_k, d)
    kl = np.asarray(k_len, np.int32)
    w = np.random.RandomState(1).randn(2, 2, t_q, d).astype(np.float32)
    ref = _jax_grads(q, k, v, kl, w, rate)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, _ = flash_attention(qt, kt, vt, torch.as_tensor(kl),
                           dropout_rate=rate, dropout_seed=RATE_SEED,
                           causal=True)
    (o * torch.as_tensor(w)).sum().backward()
    for ours, theirs in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    for g in (kt.grad, vt.grad):       # keys at or past k_len: exactly 0
        for b, n in enumerate(k_len):
            assert torch.all(g[b, :, n:] == 0)
    if t_k > t_q:                      # keys past every query row: 0 too
        assert torch.all(kt.grad[:, :, t_q:] == 0)
        assert torch.all(vt.grad[:, :, t_q:] == 0)


def test_causal_backward_is_the_formula_not_autograd():
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(3, 1, 2, 40, 30, 16))
    kl = torch.tensor([23], dtype=torch.int32)
    o, lse = flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.1, 99,
                                           causal=True)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad((o * do).sum(), (q, k, v))
    formula = flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        kl, 0.25, 0.1, 99, causal=True)
    for a, b in zip(formula, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_causal_wrappers_on_cpu_take_plain_versions_and_count_nothing():
    q, k, v = _torch(*_qkv(0, 1, 2, 30, 30, 16))
    kl = torch.tensor([21], dtype=torch.int32)
    fwd_counts = ("launches", "dropout_launches", "causal_launches",
                  "causal_dropout_launches")
    bwd = (flash_attention_bwd_dq, flash_attention_bwd_dkdv)

    def counts():
        return ([getattr(flash_attention, c) for c in fwd_counts]
                + [w.launches for w in bwd] + [w.causal_launches for w in bwd])

    before = counts()
    assert all(c >= 0 for c in before)
    kw = dict(sm_scale=0.25, dropout_rate=0.1, dropout_seed=4, causal=True)
    o, lse = flash_attention(q, k, v, kl, dropout_rate=0.1, dropout_seed=4,
                             causal=True)
    ro, rlse = flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.1, 4,
                                             causal=True)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    do = torch.ones_like(o)
    grads = flash_attention_bwd(q, k, v, o, lse, do, kl, **kw)
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do, kl, 0.25, 0.1,
                                        4, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    delta = bwd_delta(o, do)
    split = (flash_attention_bwd_dq(q, k, v, do, lse, delta, kl, **kw),
             *flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kl, **kw))
    assert all(torch.equal(a, b) for a, b in zip(split, ref))
    assert counts() == before


# ---- the CUDA kernels' tile ranges, emulated --------------------------------

def _tile() -> int:
    """The kernels' tile height, from the header both sources include."""
    header = (Path(cuda_build.CSRC) / "flash_common.cuh").read_text()
    return int(re.search(r"constexpr int BT = (\d+);", header).group(1))


def _attends(row, col, klen):
    return (col < klen) & (col <= row)


def _forward_tiles(t_q, klen, bt):
    """(q0, k0) tiles of the forward (and dq) kernel: per q tile, key
    tiles up to min(ceil(klen/BT), (q0 + BT - 1)/BT + 1)."""
    for q0 in range(0, t_q, bt):
        for kt in range(min(-(-klen // bt), (q0 + bt - 1) // bt + 1)):
            yield q0, kt * bt


def _dkdv_tiles(t_q, t_k, klen, bt, first=lambda k0, bt: k0 // bt):
    """(q0, k0) tiles of the dk/dv kernel: per key tile below k_len (a
    tile at or past it writes zeros), q tiles from ``first`` (k0 / BT)."""
    for k0 in range(0, min(t_k, klen), bt):
        for qt in range(first(k0, bt), -(-t_q // bt)):
            yield qt * bt, k0


def _visits(tiles, t_q, t_k, klen, bt):
    """How often each (row, key) pair is visited under the causal
    element predicate."""
    hits = np.zeros((t_q, t_k), np.int64)
    r, c = np.arange(bt)[:, None], np.arange(bt)[None, :]
    for q0, k0 in tiles:
        rows = np.broadcast_to(q0 + r, (bt, bt))
        cols = np.broadcast_to(k0 + c, (bt, bt))
        sel = (rows < t_q) & (cols < t_k) & _attends(rows, cols, klen)
        np.add.at(hits, (rows[sel], cols[sel]), 1)
    return hits


@pytest.mark.parametrize("t_q,t_k,klen", [
    (511, 511, 511), (511, 511, 300), (511, 511, 1), (511, 511, 65),
    (383, 383, 64), (200, 700, 650), (700, 200, 130), (64, 64, 64),
    (65, 65, 65)])
def test_tile_ranges_cover_every_attended_pair_exactly_once(t_q, t_k, klen):
    bt = _tile()
    rows = np.arange(t_q)[:, None]
    cols = np.arange(t_k)[None, :]
    want = _attends(rows, cols, klen).astype(np.int64)
    np.testing.assert_array_equal(
        _visits(_forward_tiles(t_q, klen, bt), t_q, t_k, klen, bt), want)
    np.testing.assert_array_equal(
        _visits(_dkdv_tiles(t_q, t_k, klen, bt), t_q, t_k, klen, bt), want)


def test_dkdv_starting_one_tile_late_would_drop_the_diagonal():
    # the trap that the kernel's first q tile, k0 / BT, avoids
    bt, t = _tile(), 300
    late = _visits(_dkdv_tiles(t, t, t, bt, lambda k0, bt: k0 // bt + 1),
                   t, t, t, bt)
    diag = np.arange(t)
    assert not late[diag, diag].any()


def _emulated_forward(q, k, v, klen, sm_scale, bt):
    """float64 online softmax over the forward kernel's tile range, for
    one (b, h): o (t_q, d), lse (t_q,)."""
    t_q, t_k = q.shape[0], k.shape[0]
    o = np.zeros(q.shape)
    lse = np.zeros(t_q)
    for q0 in range(0, t_q, bt):
        rows = np.arange(q0, min(q0 + bt, t_q))
        m = np.full(len(rows), -1e30)
        l = np.zeros(len(rows))
        acc = np.zeros((len(rows), q.shape[1]))
        n_tiles = min(-(-klen // bt), (q0 + bt - 1) // bt + 1)
        for kt in range(n_tiles):
            k0 = kt * bt
            cols = np.arange(k0, min(k0 + bt, t_k))
            s = q[rows] @ k[cols].T * sm_scale
            valid = _attends(rows[:, None], cols[None, :], klen)
            m_new = np.maximum(m, np.where(valid, s, -1e30).max(1))
            p = np.where(valid, np.exp(s - m_new[:, None]), 0.0)
            alpha = np.exp(m - m_new)
            l = alpha * l + p.sum(1)
            acc = alpha[:, None] * acc + p @ v[cols]
            m = m_new
        safe = np.where(l > 0, l, 1.0)
        o[rows] = acc / safe[:, None]
        lse[rows] = m + np.log(safe)
    return o, lse


@pytest.mark.parametrize("t_q,t_k,k_len", [(150, 150, [150, 97]),
                                           (130, 70, [1, 65])])
def test_emulated_tiling_matches_plain_version(t_q, t_k, k_len):
    q, k, v = _qkv(t_q * t_k, 2, 1, t_q, t_k, 8)
    kl = np.asarray(k_len, np.int32)
    ro, rlse = flash_attention_fwd_reference(*_torch(q, k, v, kl),
                                             8 ** -0.5, causal=True)
    for b in range(2):
        o, lse = _emulated_forward(q[b, 0].astype(np.float64),
                                   k[b, 0].astype(np.float64),
                                   v[b, 0].astype(np.float64), k_len[b],
                                   8 ** -0.5, _tile())
        np.testing.assert_allclose(o, ro[b, 0].numpy(), **TOL)
        np.testing.assert_allclose(lse, rlse[b, 0].numpy(), **TOL)
