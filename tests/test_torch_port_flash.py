"""The flash-attention forward of the port (K1) on the CPU.

On a CPU tensor ``flash_attention`` takes the kernel's plain version, so
these tests hold that plain version against the JAX package's Pallas
kernel in interpret mode: O against ``flash_attention(interpret=True)``
and the row logsumexp against ``_flash_fwd(interpret=True)``, in fp32 at
2e-5 (the tolerance of tests/test_flash_attention.py). The CUDA kernel is
held against the same plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_tts_tpu.ops.attention import (
    MultiHeadAttention as JMultiHeadAttention)
from transformer_tts_tpu.ops.flash_attention import (
    _flash_fwd, flash_attention as jax_flash_attention)
from transformer_tts_tpu_torch.ops import attention as port_attention
from transformer_tts_tpu_torch.ops.flash_attention import (
    _check_cuda_inputs, flash_attention, flash_attention_fwd_reference)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are small: one intra-op thread, so the module does
    not spin against the other test workers for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(seed, b, h, t_q, t_k, d):
    rs = np.random.RandomState(seed)
    return tuple(rs.randn(b, h, t, d).astype(np.float32)
                 for t in (t_q, t_k, t_k))


@pytest.mark.parametrize("t_q,t_k,d,k_len,block_q,block_k", [
    (50, 50, 32, [50, 33], 32, 32),       # T not a multiple of the block
    (96, 48, 32, [48, 17], 32, 16),       # T_q != T_k
    (40, 40, 16, [0, 25], 16, 16),        # a row with no valid key
    (64, 64, 96, [64, 50], 32, 32),       # the flagship head dim
])
def test_plain_version_matches_interpret_kernel(t_q, t_k, d, k_len,
                                                block_q, block_k):
    q, k, v = _qkv(t_q + d, 2, 2, t_q, t_k, d)
    kl = np.asarray(k_len, np.int32)
    sm_scale = d ** -0.5
    jo = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(kl), block_q=block_q,
                             block_k=block_k, interpret=True)
    _, jlse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(kl), causal=False, sm_scale=sm_scale,
                         dropout_rate=0.0, seed=jnp.zeros((), jnp.int32),
                         block_q=block_q, block_k=block_k, interpret=True)
    o, lse = flash_attention_fwd_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(kl), sm_scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    if 0 in k_len:
        row = k_len.index(0)
        assert np.all(o[row].numpy() == 0)
        assert np.all(lse[row].numpy() == np.float32(-1e30))


def test_wrapper_on_cpu_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.as_tensor(a) for a in _qkv(0, 1, 2, 30, 30, 16))
    kl = torch.tensor([21], dtype=torch.int32)
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, kl)
    ro, rlse = flash_attention_fwd_reference(q, k, v, kl, 16 ** -0.5)
    assert flash_attention.launches == before
    assert torch.equal(o, ro) and torch.equal(lse, rlse)


def _bad_inputs(kind):
    q = torch.zeros(2, 2, 8, 32)
    kl = torch.tensor([8, 8], dtype=torch.int32)
    if kind == "head_dim":
        q = torch.zeros(2, 2, 8, 100)
    elif kind == "dtype":
        q = q.half()
    elif kind == "contiguity":
        q = torch.zeros(2, 8, 2, 32).transpose(1, 2)
    elif kind == "k_len_dtype":
        kl = kl.long()
    return q, q.clone() if kind != "contiguity" else q, q, kl


@pytest.mark.parametrize("kind,error", [
    ("head_dim", ValueError), ("dtype", TypeError),
    ("contiguity", ValueError), ("k_len_dtype", ValueError)])
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(kind, error):
    with pytest.raises(error):
        _check_cuda_inputs(*_bad_inputs(kind))


def test_attention_dispatches_long_keys_to_the_kernel(monkeypatch):
    # T_k >= FLASH_MIN_KEY_LEN with a prefix mask: the port's MHA goes to
    # flash_attention; the JAX package on the CPU runs its masked-fill
    # path. With every row holding a valid key the two agree everywhere.
    calls = []

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return flash_attention(*args, **kw)

    monkeypatch.setattr(port_attention, "flash_attention", counting)
    t = port_attention.FLASH_MIN_KEY_LEN
    rs = np.random.RandomState(1)
    x = rs.randn(2, t, 32).astype(np.float32)
    k_len = np.array([t, 100], np.int32)
    mask = (np.arange(t)[None] < k_len[:, None])[:, None, :]
    mha = port_attention.MultiHeadAttention(2, 32, dropout=0.0,
                                            use_flash=True).eval()
    params = {}
    for name in ("q_linear", "k_linear", "v_linear", "out"):
        lin = getattr(mha, name)
        params[name] = {"kernel": lin.weight.detach().numpy().T,
                        "bias": lin.bias.detach().numpy()}
    ref, _ = JMultiHeadAttention(heads=2, d_model=32, dropout=0.0).apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
        jnp.asarray(mask), train=False)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        ours, probs = mha(xt, xt, xt, torch.as_tensor(mask),
                          k_len=torch.as_tensor(k_len))
    assert calls == [(2, 2, t, 16)] and probs is None
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
