"""The port's additive-bias flash attention (K6, K6-d and K6's backward) on
the CPU.

On a CPU tensor the wrappers take the kernels' plain versions, so these
tests hold ``flash_attention_with_bias`` against the JAX package's
``flash_attention_with_bias(..., interpret=True)`` on the same numpy
inputs: O at 2e-5 and the q, k, v and bias gradients (through
the ``tts_port::flash_fwd`` op's autograd, whose CPU backward is the plain K6 backward, not
autograd) against ``jax.grad`` of the interpret-mode kernel at 1e-4, the
tolerances tests/test_flash_attention.py holds JAX's own kernel to, at
dropout 0 and 0.1 (the hash bit for bit ``_keep_mask``). The conformer's
two routes, the in-kernel relative bias (K4/K5) and the bias built in
device memory then K6, agree on O and all five gradients at 1e-5. The CUDA
kernels are held against the same plain versions on the card by
chip_smoke.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.ops.flash_attention import (
    flash_attention_with_bias as jax_flash_bias)
from transformer_tts_tpu_torch.ops import cuda_build
from transformer_tts_tpu_torch.ops import flash_attention as fa
from transformer_tts_tpu_torch.ops import flash_relpos as fr


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE_TOL = dict(rtol=0, atol=1e-5)
SEED = -123456789                   # an int32 whose uint32 bits wrap
NAMES = ("dq", "dk", "dv", "dbias")


def _data(t_q, t_k, k_len, b=2, h=2, d=32, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, t_q, d).astype(np.float32)
    k, v = (rs.randn(b, h, t_k, d).astype(np.float32) for _ in range(2))
    bias = (2 * rs.randn(b, h, t_q, t_k)).astype(np.float32)
    g = rs.randn(b, h, t_q, d).astype(np.float32)
    return (q, k, v, bias), np.asarray(k_len, np.int32), g


def _port(inputs, kl, g, rate=0.0, seed=0):
    """o and the four gradients of sum(o * g) through the tts_port::flash_fwd op."""
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    o, _ = fa.flash_attention_with_bias(*xs, torch.as_tensor(kl),
                                        dropout_rate=rate, dropout_seed=seed)
    grads = torch.autograd.grad((o * torch.as_tensor(g)).sum(), xs)
    return o.detach().numpy(), [x.numpy() for x in grads]


def _jax(inputs, kl, g, rate=0.0, seed=0, block=16):
    def fn(q, k, v, bias):
        return jax_flash_bias(q, k, v, bias, jnp.asarray(kl),
                              dropout_rate=rate, dropout_seed=jnp.int32(seed),
                              block_q=block, block_k=block, interpret=True)

    def loss(*a):
        return jnp.sum(fn(*a) * jnp.asarray(g))
    args = [jnp.asarray(x) for x in inputs]
    return (np.asarray(fn(*args)),
            [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2, 3))(
                *args)])


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, SEED)])
@pytest.mark.parametrize("t_q,t_k,k_len", [
    (64, 64, [37, 0]),                # a short row and a row with no key
    (48, 80, [19, 0]),                # T_q != T_k
])
def test_forward_and_gradients_match_interpret_kernel(t_q, t_k, k_len, rate,
                                                      seed):
    inputs, kl, g = _data(t_q, t_k, k_len, seed=t_q + t_k)
    o, grads = _port(inputs, kl, g, rate, seed)
    jo, jgrads = _jax(inputs, kl, g, rate, seed)
    np.testing.assert_allclose(o, jo, **FWD_TOL)
    for name, a, b in zip(NAMES, grads, jgrads):
        np.testing.assert_allclose(a, b, err_msg=name, **GRAD_TOL)
    dbias = grads[3]
    for b, n in enumerate(kl):
        assert not dbias[b, :, :, n:].any()     # exactly 0 past k_len
    assert np.abs(dbias[0, :, :, :k_len[0]]).max() > 0
    if rate:
        plain, _ = fa.flash_attention_fwd_reference(
            *(torch.as_tensor(x) for x in inputs[:3]), torch.as_tensor(kl),
            32 ** -0.5, bias=torch.as_tensor(inputs[3]))
        assert not np.allclose(o, plain.numpy())     # dropout took effect


def test_bias_is_added_before_the_scale():
    # a bias of c on every logit leaves the softmax as it is; its gradient
    # is the pre-scale logit gradient, so dbias sums to 0 over each row
    inputs, kl, g = _data(24, 24, [24, 10], d=16, seed=3)
    q, k, v, bias = (torch.as_tensor(x) for x in inputs)
    kl = torch.as_tensor(kl)
    base, _ = fa.flash_attention_fwd_reference(q, k, v, kl, 0.25, bias=bias)
    shifted, _ = fa.flash_attention_fwd_reference(q, k, v, kl, 0.25,
                                                  bias=bias + 7.0)
    torch.testing.assert_close(base, shifted, rtol=0, atol=1e-5)
    scaled = torch.matmul(q, k.transpose(-1, -2)) + bias
    s = torch.where(torch.arange(24)[None, None, None, :]
                    < kl[:, None, None, None], scaled * 0.25, -1e30)
    want = torch.matmul(torch.softmax(s, -1), v)
    torch.testing.assert_close(base, want, rtol=0, atol=1e-5)
    _, grads = _port(inputs, kl.numpy(), g)
    np.testing.assert_allclose(grads[3].sum(-1), 0.0, atol=1e-5)


def test_cpu_backward_is_the_plain_k6_backward(monkeypatch):
    calls = []
    real = fa.flash_attention_bwd_reference

    def recording(name):
        plain = getattr(fa, name)

        def record(*args, **kw):
            calls.append((name, kw.get("bias", args[11] if len(args) > 11
                                        else None)))
            return plain(*args, **kw)
        return record

    # the op's CPU backward: the plain dq (and dbias) and dk/dv, from delta
    for name in ("flash_attention_dq_reference",
                 "flash_attention_dkdv_reference"):
        monkeypatch.setattr(fa, name, recording(name))
    inputs, kl, g = _data(20, 28, [28, 5], d=8, seed=5)
    xs = [torch.tensor(x, requires_grad=True) for x in inputs]
    o, lse = fa.flash_attention_with_bias(*xs, torch.as_tensor(kl),
                                          dropout_rate=0.1, dropout_seed=3)
    # the gradient comes from the tts_port::flash_fwd op's autograd
    assert "tts_port_flash_fwd" in type(o.grad_fn).__name__
    assert not lse.requires_grad
    grads = torch.autograd.grad((o * torch.as_tensor(g)).sum(), xs)
    assert [name for name, _ in calls] == [
        "flash_attention_dq_reference", "flash_attention_dkdv_reference"]
    assert all(bias is not None for _, bias in calls)
    with torch.no_grad():
        o2, lse2 = fa.flash_attention_with_bias(*xs, torch.as_tensor(kl),
                                                dropout_rate=0.1,
                                                dropout_seed=3)
        want = real(*xs[:3], o2, lse2, torch.as_tensor(g),
                    torch.as_tensor(kl), 8 ** -0.5, 0.1, 3, bias=xs[3])
    for got, w in zip(grads, want):
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_wrappers_on_cpu_take_plain_versions_and_launch_nothing():
    inputs, kl, g = _data(40, 40, [40, 11], d=16, seed=6)
    q, k, v, bias = (torch.as_tensor(x) for x in inputs)
    kl, do = torch.as_tensor(kl), torch.as_tensor(g)
    sm_scale = 16 ** -0.5
    counters = [(fa.flash_attention_with_bias, "launches"),
                (fa.flash_attention_with_bias, "dropout_launches"),
                (fa.flash_attention_bwd_dq, "bias_launches"),
                (fa.flash_attention_bwd_dkdv, "bias_launches")]
    before = [getattr(obj, attr) for obj, attr in counters]
    o, lse = fa.flash_attention_with_bias(q, k, v, bias, kl,
                                          dropout_rate=0.1, dropout_seed=5)
    delta = fa.bwd_delta(o, do)
    kw = dict(sm_scale=sm_scale, dropout_rate=0.1, dropout_seed=5,
              bias=bias)
    dq, dbias = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, kl, **kw)
    dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kl, **kw)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, kl, sm_scale,
                                           0.1, 5, bias=bias)
    for got, want in zip((dq, dk, dv, dbias), ref):
        assert torch.equal(got, want)
    assert [getattr(obj, attr) for obj, attr in counters] == before


@pytest.mark.parametrize("kind", ["shape", "dtype", "broadcast",
                                  "non_contiguous"])
def test_bias_checks(kind):
    inputs, kl, _ = _data(16, 24, [24, 3], d=8, seed=7)
    q, k, v, bias = (torch.as_tensor(x) for x in inputs)
    error = ValueError
    if kind == "shape":
        bias = bias[:, :, :, :20].contiguous()
    elif kind == "dtype":
        bias, error = bias.double(), TypeError
    elif kind == "broadcast":
        bias = bias[:1].contiguous()
    else:
        bias = bias.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(error):
        fa.flash_attention_with_bias(q, k, v, bias, torch.as_tensor(kl))


@pytest.mark.parametrize("rate,seed", [(0.0, 0), (0.1, SEED)])
def test_the_two_conformer_routes_agree(rate, seed):
    # route 1: K4/K5 build rel_shift(q_v P^T) per tile; route 2: the bias in
    # device memory, then K6 -- the A/B of scripts/flash_ab.py's relpos mode
    rs = np.random.RandomState(11)
    b, h, t, d = 2, 2, 40, 16
    raw = [rs.randn(b, h, t, d).astype(np.float32) for _ in range(4)]
    raw.append(rs.randn(h, t, d).astype(np.float32))
    kl = torch.as_tensor(np.asarray([t, 23], np.int32))
    g = torch.as_tensor(rs.randn(b, h, t, d).astype(np.float32))

    def run(route):
        xs = [torch.tensor(x, requires_grad=True) for x in raw]
        q_u, q_v, k, v, p = xs
        if route == 1:
            o, _ = fr.flash_relpos_attention(q_u, q_v, k, v, p, kl,
                                             dropout_rate=rate,
                                             dropout_seed=seed)
        else:
            bias = fr.rel_shift(torch.matmul(q_v, p.transpose(-1, -2)))
            o, _ = fa.flash_attention_with_bias(q_u, k, v, bias.contiguous(),
                                                kl, dropout_rate=rate,
                                                dropout_seed=seed)
        return o, torch.autograd.grad((o * g).sum(), xs)

    o1, g1 = run(1)
    o2, g2 = run(2)
    torch.testing.assert_close(o2, o1, **ROUTE_TOL)
    for name, a, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), g2, g1):
        torch.testing.assert_close(a, w, **ROUTE_TOL, msg=name)


BT = 64         # the CUDA kernels' tile


@pytest.mark.parametrize("t_q,t_k,k_len", [
    (300, 700, [700, 65, 0, 1]), (1000, 1000, [1000, 0, 1, 65]),
    (64, 128, [64, 128])])
def test_dq_kernel_writes_every_dbias_element_once(t_q, t_k, k_len):
    # the tile plan of flash_bwd_dq_kernel: per (q tile, batch row) the key
    # loop's tiles below k_len store dS, then the rest store zeros
    for n in k_len:
        written = np.zeros((t_q, t_k), np.int32)
        from_loop = np.zeros((t_q, t_k), bool)
        n_tiles = -(-n // BT)
        for q0 in range(0, t_q, BT):
            kt = 0
            while kt * BT < t_k:
                rows = slice(q0, min(q0 + BT, t_q))
                cols = slice(kt * BT, min(kt * BT + BT, t_k))
                written[rows, cols] += 1
                from_loop[rows, cols] = kt < n_tiles
                kt += 1
        assert (written == 1).all()
        assert from_loop[:, :n].all()      # every valid key's dS is stored


def test_kernels_take_the_bias_helpers_from_the_shared_header():
    csrc = Path(cuda_build.CSRC)
    common = (csrc / "flash_common.cuh").read_text()
    assert "void add_bias(" in common and "void store_bias_tile(" in common
    fwd = (csrc / "flash_attention_fwd.cu").read_text()
    bwd = (csrc / "flash_attention_bwd.cu").read_text()
    assert fwd.count("add_bias(sS") == 1
    assert bwd.count("add_bias(sS") == 2             # dq and dk/dv
    assert "store_bias_tile(dbb, sDS" in bwd
