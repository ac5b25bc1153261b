"""The port's flash-attention dropout forward (K1-d) and backward (K2) on
the CPU.

On a CPU tensor the wrappers take the kernels' plain versions, so these
tests hold those plain versions against the JAX package's Pallas kernels
in interpret mode: the dropout hash bit for bit against ``_keep_mask``, the
dropout forward against ``flash_attention(interpret=True)`` at 1e-5, and
the ``flash_attention`` gradients (the ``tts_port::flash_fwd`` op's
autograd) against ``jax.grad`` of the interpret-mode
kernel at 1e-4 (the tolerance of tests/test_flash_attention.py). The CUDA
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
    _flash_fwd, _keep_mask, flash_attention as jax_flash_attention)
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops import cuda_build
from transformer_tts_tpu_torch.ops.flash_attention import (
    _check_bwd_inputs, _dropout_args, bwd_delta, flash_attention,
    flash_attention_bwd, flash_attention_bwd_dkdv, flash_attention_bwd_dq,
    flash_attention_bwd_reference, flash_attention_fwd_reference, keep_mask)

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _qkv(seed, b, h, t_q, t_k, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (t_q, t_k, t_k))


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("offset", [0, 64, 1000])
@pytest.mark.parametrize("bh", [0, 5])
@pytest.mark.parametrize("seed", [0, 123, -7, 2 ** 31 - 1])
def test_keep_mask_equals_jax_bit_for_bit(seed, bh, offset, rate):
    shape = (24, 40)
    ref = np.asarray(_keep_mask(jnp.int32(seed), jnp.int32(bh),
                                jnp.int32(offset), jnp.int32(2 * offset),
                                shape, rate))
    ours = keep_mask(seed, bh, offset, 2 * offset, shape, rate).numpy()
    assert ours.dtype == np.float32 and ours.shape == shape
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    kept = (ours > 0).mean()
    assert abs(kept - (1 - rate)) < 0.15


def test_both_kernels_take_the_hash_and_products_from_one_header():
    # the backward rebuilds the forward's keep mask: one copy of the hash
    csrc = Path(cuda_build.CSRC)
    assert "bool keep_bit(" in (csrc / "flash_common.cuh").read_text()
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        src = (csrc / f"{name}.cu").read_text()
        assert '#include "flash_common.cuh"' in src
        assert "keep_bit(uint32_t" not in src
        assert "struct Products" not in src


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    first = cuda_build.library_path("k")
    assert cuda_build.library_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert cuda_build.library_path("k") != first


def test_dropout_args_wrap_the_seed_and_take_jax_threshold():
    flag, threshold, scale, seed = _dropout_args(0.1, -7)
    assert (flag, threshold, seed) == (1, int(0.1 * 2 ** 32), 2 ** 32 - 7)
    assert scale == float(np.float32(1) / np.float32(0.9))
    assert _dropout_args(0.0, 5) == (0, 0, 1.0, 0)
    with pytest.raises(ValueError):
        _dropout_args(1.0, 0)


@pytest.mark.parametrize("t_q,t_k,d,k_len,seed", [
    (50, 50, 32, [50, 33], 11),       # T not a multiple of the block
    (96, 48, 32, [48, 17], -3),       # T_q != T_k
    (40, 40, 16, [0, 25], 2 ** 31 - 1),   # a row with no valid key
])
def test_dropout_forward_matches_interpret_kernel(t_q, t_k, d, k_len, seed):
    q, k, v = _qkv(t_q + t_k + d, 2, 2, t_q, t_k, d)
    kl = np.asarray(k_len, np.int32)
    sm_scale = d ** -0.5
    args = [jnp.asarray(x) for x in (q, k, v, kl)]
    jo = jax_flash_attention(*args, dropout_rate=0.3, dropout_seed=seed,
                             block_q=16, block_k=16, interpret=True)
    _, jlse = _flash_fwd(*args, causal=False, sm_scale=sm_scale,
                         dropout_rate=0.3, seed=jnp.int32(seed), block_q=16,
                         block_k=16, interpret=True)
    o, lse = flash_attention_fwd_reference(
        *(torch.as_tensor(x) for x in (q, k, v, kl)), sm_scale, 0.3, seed)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    plain, _ = flash_attention_fwd_reference(
        *(torch.as_tensor(x) for x in (q, k, v, kl)), sm_scale)
    assert not torch.allclose(o, plain)          # dropout took effect


def _jax_grads(q, k, v, kl, w, rate, seed, block_q=16, block_k=16):
    def loss(q, k, v):
        o = jax_flash_attention(q, k, v, jnp.asarray(kl), dropout_rate=rate,
                                dropout_seed=seed, block_q=block_q,
                                block_k=block_k, interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))


@pytest.mark.parametrize("rate", [0.0, 0.4])
@pytest.mark.parametrize("t_q,t_k,d,k_len", [
    (32, 32, 16, [32, 20]),
    (40, 32, 16, [32, 0]),        # padded q rows; a row with no valid key
    (48, 80, 32, [80, 37]),       # T_q != T_k, ragged
])
def test_function_gradients_match_jax_grad(t_q, t_k, d, k_len, rate):
    q, k, v = _qkv(7 + t_k, 2, 2, t_q, t_k, d)
    kl = np.asarray(k_len, np.int32)
    w = np.random.RandomState(1).randn(2, 2, t_q, d).astype(np.float32)
    ref = _jax_grads(q, k, v, kl, w, rate, seed=-11)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o, _ = flash_attention(qt, kt, vt, torch.as_tensor(kl),
                           dropout_rate=rate, dropout_seed=-11)
    (o * torch.as_tensor(w)).sum().backward()
    for ours, theirs in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   **GRAD_TOL)
    for g in (kt.grad, vt.grad):       # keys at or past k_len: exactly 0
        for b, n in enumerate(k_len):
            assert torch.all(g[b, :, n:] == 0)


def test_backward_is_the_formula_not_autograd():
    # the plain backward equals autograd through the plain forward (same
    # function), yet it is computed from lse and the hash alone
    q, k, v = (torch.tensor(x, requires_grad=True)
               for x in _qkv(3, 1, 2, 24, 24, 16))
    kl = torch.tensor([19], dtype=torch.int32)
    o, lse = flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.2, 99)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    auto = torch.autograd.grad((o * do).sum(), (q, k, v))
    formula = flash_attention_bwd_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        kl, 0.25, 0.2, 99)
    for a, b in zip(formula, auto):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


def test_wrappers_on_cpu_take_plain_versions_and_launch_nothing():
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 2, 30, 30, 16))
    kl = torch.tensor([21], dtype=torch.int32)
    counters = (flash_attention, flash_attention_bwd_dq,
                flash_attention_bwd_dkdv)
    counts = [c.launches for c in counters] + [
        flash_attention.dropout_launches]
    o, lse = flash_attention(q, k, v, kl, dropout_rate=0.1, dropout_seed=4)
    ro, rlse = flash_attention_fwd_reference(q, k, v, kl, 0.25, 0.1, 4)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    do = torch.ones_like(o)
    kw = dict(sm_scale=0.25, dropout_rate=0.1, dropout_seed=4)
    grads = flash_attention_bwd(q, k, v, o, lse, do, kl, **kw)
    ref = flash_attention_bwd_reference(q, k, v, o, lse, do, kl, 0.25, 0.1,
                                        4)
    assert all(torch.equal(a, b) for a, b in zip(grads, ref))
    delta = bwd_delta(o, do)
    split = (flash_attention_bwd_dq(q, k, v, do, lse, delta, kl, **kw),
             *flash_attention_bwd_dkdv(q, k, v, do, lse, delta, kl, **kw))
    assert all(torch.equal(a, b) for a, b in zip(split, ref))
    assert counts == [c.launches for c in counters] + [
        flash_attention.dropout_launches]


@pytest.mark.parametrize("kind", ["do_shape", "do_dtype", "lse_dtype",
                                  "delta_shape", "do_contiguity"])
def test_backward_wrapper_rejects_what_the_kernel_cannot_take(kind):
    q = torch.zeros(2, 2, 8, 32)
    kl = torch.tensor([8, 8], dtype=torch.int32)
    do, lse, delta = q.clone(), torch.zeros(2, 2, 8), torch.zeros(2, 2, 8)
    if kind == "do_shape":
        do = torch.zeros(2, 2, 9, 32)
    elif kind == "do_dtype":
        do = do.bfloat16()
    elif kind == "lse_dtype":
        lse = lse.double()
    elif kind == "delta_shape":
        delta = torch.zeros(2, 2, 9)
    else:
        do = torch.zeros(2, 2, 32, 8).transpose(2, 3)
    with pytest.raises(ValueError):
        _check_bwd_inputs(q, q.clone(), q.clone(), do, lse, delta, kl)


def test_attention_train_mode_draws_its_seed_from_the_generator(monkeypatch):
    # the kernel path in train mode: dropout inside the kernel, the seed an
    # int32 drawn from the caller's CPU generator, fresh per call
    seeds = []

    def recording(*args, **kw):
        seeds.append((kw["dropout_rate"], kw["dropout_seed"]))
        return flash_attention(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", recording)
    t = port_attention.FLASH_MIN_KEY_LEN
    mha = port_attention.MultiHeadAttention(2, 32, dropout=0.1,
                                            use_flash=True).train()
    x = torch.randn(2, t, 32, generator=torch.Generator().manual_seed(0))
    k_len = torch.tensor([t, 100], dtype=torch.int32)
    mask = (torch.arange(t)[None] < k_len[:, None])[:, None, :]
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append(mha(x, x, x, mask, k_len=k_len, generator=gen)[0])
    outs.append(mha(x, x, x, mask, k_len=k_len, generator=gen)[0])
    expect = int(torch.randint(-2 ** 31, 2 ** 31, (),
                               generator=torch.Generator().manual_seed(5)))
    assert seeds[0] == seeds[1] == (0.1, expect)
    assert seeds[2][1] != expect
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    mha.eval()
    mha(x, x, x, mask, k_len=k_len)
    assert seeds[3] == (0.0, 0)
