"""The kernels' ``tts_port`` custom ops on the CPU.

``torch.library.opcheck`` (schema, fake implementation, autograd
registration, tracing with dynamic shapes) on every op of
ops/flash_attention.py and ops/flash_relpos.py at small shapes, with and
without dropout, causal and with a bias; and the gradients through each
forward op's registered autograd equal, bit for bit, the plain backward
called on its own (one case per kernel family: K1/K2, the causal K3, the
bias K6, the relative K4/K5). The CUDA implementations are checked the
same way on the card by chip_smoke.py's phase 20.
"""

import numpy as np
import pytest
import torch

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


SEED = 7
SCALE = 0.3
FLASH_MODES = {"plain": (False, False), "causal": (True, False),
               "bias": (False, True)}
# the backward ops' ``kernel`` argument: the design's choice, the simple
# pair, or one kernel
BWD_KERNELS = ("auto", "simple", "dq", "dkdv", "sm90")


def _t(rs, *shape):
    return torch.tensor(rs.randn(*shape), dtype=torch.float32)


def _flash_inputs(bias: bool, t_q=5, t_k=7):
    rs = np.random.RandomState(SEED)
    q, k, v = _t(rs, 2, 2, t_q, 8), _t(rs, 2, 2, t_k, 8), _t(rs, 2, 2, t_k, 8)
    k_len = torch.tensor([t_k, 3], dtype=torch.int32)
    return q, k, v, k_len, (_t(rs, 2, 2, t_q, t_k) if bias else None), \
        _t(rs, 2, 2, t_q, 8)


def _relpos_inputs(t=6):
    rs = np.random.RandomState(SEED)
    xs = [_t(rs, 2, 2, t, 8) for _ in range(4)]
    return (*xs, _t(rs, 2, t, 8), torch.tensor([t, 3], dtype=torch.int32),
            _t(rs, 2, 2, t, 8))


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("mode", sorted(FLASH_MODES))
def test_flash_ops_pass_opcheck(mode, rate):
    causal, with_bias = FLASH_MODES[mode]
    q, k, v, k_len, bias, do = _flash_inputs(with_bias)
    grads = [x.clone().requires_grad_() for x in (q, k, v)]
    gbias = None if bias is None else bias.clone().requires_grad_()
    args = (*grads, k_len, gbias, SCALE, rate, SEED, causal, "auto")
    torch.library.opcheck(fa._flash_fwd_op, args)
    o, lse = fa._flash_fwd_op(*args)
    delta = fa.bwd_delta(o.detach(), do)
    for kernel in BWD_KERNELS:
        torch.library.opcheck(fa._flash_bwd_op,
                              (q, k, v, do, lse, delta, k_len, bias, SCALE,
                               rate, SEED, causal, kernel))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_relpos_ops_pass_opcheck(rate):
    q_u, q_v, k, v, p, k_len, do = _relpos_inputs()
    grads = [x.clone().requires_grad_() for x in (q_u, q_v, k, v, p)]
    args = (*grads, k_len, SCALE, rate, SEED, "auto")
    torch.library.opcheck(fr._relpos_fwd_op, args)
    o, lse = fr._relpos_fwd_op(*args)
    delta = fr.bwd_delta(o.detach(), do)
    for kernel in BWD_KERNELS:
        torch.library.opcheck(fr._relpos_bwd_op,
                              (q_u, q_v, k, v, p, do, lse, delta, k_len,
                               SCALE, rate, SEED, kernel))


@pytest.mark.parametrize("mode", sorted(FLASH_MODES))
def test_flash_op_gradients_are_the_plain_backward(mode):
    causal, with_bias = FLASH_MODES[mode]
    q, k, v, k_len, bias, do = _flash_inputs(with_bias)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    if bias is not None:
        xs.append(bias.clone().requires_grad_())
        o, lse = fa.flash_attention_with_bias(
            *xs[:3], xs[3], k_len, sm_scale=SCALE, dropout_rate=0.1,
            dropout_seed=SEED)
    else:
        o, lse = fa.flash_attention(*xs, k_len, sm_scale=SCALE,
                                    dropout_rate=0.1, dropout_seed=SEED,
                                    causal=causal)
    assert "tts_port_flash_fwd" in type(o.grad_fn).__name__
    assert not lse.requires_grad
    got = torch.autograd.grad((o * do).sum(), xs)
    want = fa.flash_attention_bwd_reference(
        q, k, v, o.detach(), lse, do, k_len, SCALE, 0.1, SEED, causal, bias)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_relpos_op_gradients_are_the_plain_backward():
    q_u, q_v, k, v, p, k_len, do = _relpos_inputs()
    xs = [x.clone().requires_grad_() for x in (q_u, q_v, k, v, p)]
    o, lse = fr.flash_relpos_attention(*xs, k_len, sm_scale=SCALE,
                                       dropout_rate=0.1, dropout_seed=SEED)
    assert "tts_port_relpos_fwd" in type(o.grad_fn).__name__
    assert not lse.requires_grad
    got = torch.autograd.grad((o * do).sum(), xs)
    want = fr.flash_relpos_attention_bwd_reference(
        q_u, q_v, k, v, p, o.detach(), lse, do, k_len, SCALE, 0.1, SEED)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_every_kernel_wrapper_goes_through_its_op():
    """Each public wrapper calls its tts_port op (the profiler records
    every op called)."""
    q, k, v, k_len, bias, do = _flash_inputs(True)
    o, lse = fa.flash_attention(q, k, v, k_len)
    delta = fa.bwd_delta(o, do)
    r = _relpos_inputs()
    ro, rlse = fr.flash_relpos_attention(*r[:6])
    rdelta = fr.bwd_delta(ro, r[6])
    rargs = (*r[:5], r[6], rlse, rdelta, r[5])
    calls = [
        ("flash_fwd", lambda: fa.flash_attention(q, k, v, k_len)),
        ("flash_fwd", lambda: fa.flash_attention_with_bias(q, k, v, bias,
                                                           k_len)),
        ("flash_bwd", lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, k_len, sm_scale=SCALE)),
        *(("flash_bwd", lambda fn=fn: fn(
            q, k, v, do, lse, delta, k_len, sm_scale=SCALE))
          for fn in (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
                     fa.flash_attention_bwd_sm90)),
        ("relpos_fwd", lambda: fr.flash_relpos_attention(*r[:6])),
        ("relpos_bwd", lambda: fr.flash_relpos_attention_bwd(
            *r[:5], ro, rlse, r[6], r[5], sm_scale=SCALE)),
        *(("relpos_bwd", lambda fn=fn: fn(*rargs, sm_scale=SCALE))
          for fn in (fr.flash_relpos_attention_bwd_dq,
                     fr.flash_relpos_attention_bwd_dkdv,
                     fr.flash_relpos_attention_bwd_sm90)),
    ]
    for op, call in calls:
        with torch.profiler.profile() as prof:
            call()
        assert f"tts_port::{op}" in {e.name for e in prof.events()}, op
