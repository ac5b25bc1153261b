"""Relative-position flash attention: the hand-written Hopper kernels and
their plain versions.

``flash_relpos_attention`` replaces the TPU kernel ``_fwd_kernel`` driven
by ``_relpos_fwd`` (transformer_tts_tpu/ops/flash_relpos.py:212-322), the
conformer's Transformer-XL self-attention. It computes

    s   = (q_u k^T + rel_shift(q_v P^T)) * sm_scale, keys c < k_len[b]
    o   = (softmax(s) * keep) v
    lse = row logsumexp of s (fp32)

with P (H, T, d) the projected position table shared over the batch,
without writing the (B, H, T, T) logits or the bias to device memory.
Keys at or past ``k_len[b]`` are excluded exactly; a row with no valid
key gives o = 0 and lse = -1e30, as K1 (ops/flash_attention.py) does.
``keep`` is K1-d's counter-hash keep mask at bh = b*H + h (the TPU
kernel's ``_keep_mask`` at :253-255); the normaliser sums the
probabilities before dropout.

``rel_shift`` is the reference's pad-and-reshape shift. On one tile the
kernels build its result from the three-branch identity instead
(transformer_tts_tpu/ops/flash_relpos.py:17-23):

    bd[i, j] = q_v[i]   . P[T-1-(i-j)]   for j <= i
             = 0                         for j == i+1
             = q_v[i+1] . P[j-i-2]       for j >= i+2

Kernels, CUDA C++ for sm_90a in fp32 and bf16:

* K4 (rate 0) and K4-d (dropout), ``csrc/flash_relpos_fwd.cu``. Bound by
  the tensor-core rate: 6*H*T*sum(k_len)*d operations (q_u.K^T, q_v.P^T
  and P.V over the valid keys) over 989 TFLOP/s in bf16, against q_u,
  q_v, k, v, o and P moved once over 3.35 TB/s.
* K5, ``csrc/flash_relpos_bwd.cu``: the backward (``_fused_bwd_kernel``
  :510, ``_dq_kernel`` :360, ``_dkdv_kernel`` :431, driven by
  ``_relpos_bwd`` :597) as two kernels in the FlashAttention-2 shape of
  K2: a dq kernel (dq_u, dq_v and dq_vs, the share of q_v's shifted copy,
  which the wrapper adds one row down) with 10*H*d operations per
  attended (row, key) pair, and a dk/dv/dP kernel (dP summed over the
  batch with fp32 atomics into an (H, T, d) buffer) with 12*H*d.
  ``delta = rowsum(dO * O)`` is a torch reduction, as for K2.

The models' mode -- bf16, d in ``SM90_HEAD_DIMS``, 16-byte aligned inputs
-- has a second design written for Hopper (``flash_attention.select_design``
picks it, as for K1/K2; nothing falls back from one to the other):

* K4 and K4-d, ``csrc/flash_relpos_fwd_sm90.cu``: TMA loads into
  mbarrier-guarded rings (K/V tiles, and 64-row slices of the position
  table E = [P; 0; P], ``position_table``), a producer warpgroup and two
  consumer warpgroups, ``wgmma`` products; the bias of a tile is one
  product against a 128-row window of E, skewed through shared memory.
  Beside o (bf16, P cast once, as the TPU kernel does) it writes o32, the
  output in fp32 over P's two bf16 parts, and the backward's delta =
  rowsum(dO * o32) holds to ~2^-16 of sum_j P dP: from the bf16 o it
  missed by ~2^-9, dS = P (dP - delta) no longer summed to 0 over a row,
  and in bf16 training that drove the mean of K, and q_u along it
  (directions softmax gives no gradient), until the logits broke the
  backward (the conformer of ``egs/synthetic_overfit.py`` diverged by
  step ~400; the masked path and fp32 did not). o32 is written only
  where autograd will keep it (``_forward``): synthesis and eval skip its
  second P.V. The simple kernel writes it too, from the same two parts.
* K5, ``csrc/flash_relpos_bwd_sm90.cu``: one fused kernel per 128 keys,
  dK and dV in registers, dq_u, dq_v and dE summed with fp32 atomics into
  zeroed accumulators (``flash_relpos_attention_bwd_sm90``); dP =
  dE[:T] + dE[T+1:] (``dp_from_table``).

fp32 stays on the simple design, which also stays reachable for the
same-run A/B (``design="simple"``).

The kernels are reached through two ``tts_port`` custom ops, as in
ops/flash_attention.py: ``tts_port::relpos_fwd`` (K4/K4-d) and
``tts_port::relpos_bwd`` (from delta, K5 of ``select_design``'s choice,
the simple pair, or one K5 kernel).
``flash_relpos_attention`` is differentiable in q_u, q_v, k, v and p
through the forward op's registered autograd. On a CPU tensor every
wrapper computes
the plain version; on a CUDA tensor it launches its kernel or raises. The
launch counts are ``flash_relpos_attention.launches`` (K4),
``.dropout_launches`` (K4-d), ``.sm90_launches`` and
``.sm90_dropout_launches`` (the Hopper design's K4 and K4-d),
``flash_relpos_attention_bwd_dq.launches`` and
``flash_relpos_attention_bwd_dkdv.launches`` (K5),
``flash_relpos_attention_bwd_sm90.launches`` (the Hopper design's fused
K5). PERF.md holds their measured times.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from transformer_tts_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE, _aligned, _check_bwd_inputs, _check_cuda_inputs,
    _dropout_args, _full_keep_mask, _head_args, _plain, _raise_on,
    _valid_keys, bwd_delta, masked_softmax_pv, select_design)

KERNEL = "flash_relpos_fwd"
BWD_KERNEL = "flash_relpos_bwd"
SM90_KERNEL = "flash_relpos_fwd_sm90"
SM90_BWD_KERNEL = "flash_relpos_bwd_sm90"


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift of (B, H, T_q, T_pos) scores
    (the port of transformer_tts_tpu/ops/attention.py:204-213)."""
    b, h, t1, t2 = x.shape
    padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    return padded.reshape(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)


def rel_shift_adjoint(y: torch.Tensor) -> torch.Tensor:
    """The transpose of ``rel_shift``: the gradient of its input for the
    gradient ``y`` of its output. The pad-reshape undone step by step:
    reshape to (T_pos, T_q), prepend a zero row, reshape to
    (T_q, T_pos + 1), drop the first (pad) column."""
    b, h, t1, t2 = y.shape
    rows = torch.cat([y.new_zeros(b, h, 1, t1),
                      y.reshape(b, h, t2, t1)], dim=2)
    return rows.reshape(b, h, t1, t2 + 1)[..., 1:]


def position_table(p: torch.Tensor) -> torch.Tensor:
    """E = [P; 0; P], (H, 2T+1, d) in p's dtype: with m = j - i + T - 1,
    rel_shift(q_v P^T)[i, j] = q_v[i] . E[m] for m <= T - 1 (j <= i), 0 for
    m = T, q_v[i+1] . E[m] for m >= T + 1 (j >= i + 2). The Hopper
    kernels' one position table for both branches (the port's
    counterpart of the TPU's padded ``_build_p_big``)."""
    h, _, d = p.shape
    return torch.cat([p, p.new_zeros(h, 1, d), p], dim=1).contiguous()


def dp_from_table(de: torch.Tensor) -> torch.Tensor:
    """dP from the gradient of ``position_table``'s output: the sum of
    its two copies' rows, dE[..., :T, :] + dE[..., T+1:, :]."""
    t = (de.shape[-2] - 1) // 2
    return de[..., :t, :] + de[..., t + 1:, :]


# ---- plain versions ---------------------------------------------------------

def _scores(q_u, q_v, k, p, sm_scale):
    """(q_u k^T + rel_shift(q_v P^T)) * sm_scale in fp32."""
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = rel_shift(torch.matmul(q_v.float(), p.float().transpose(-1, -2)))
    return (ac + bd) * sm_scale


def _keep(shape, dropout_rate, dropout_seed, device, head_offset=0,
          heads_total=None):
    if dropout_rate <= 0.0:
        return None
    b, h, t_q, t_k = shape
    return _full_keep_mask(b, h, t_q, t_k, dropout_seed, dropout_rate,
                           device, head_offset, heads_total)


def flash_relpos_attention_fwd_reference(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, k_len: torch.Tensor, sm_scale: float,
    dropout_rate: float = 0.0, dropout_seed: int = 0, head_offset: int = 0,
    heads_total: Optional[int] = None, with_fp32: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K4 and K4-d: the same (o, lse), the keep
    mask at ``flash_attention.hash_heads``'s batch-heads; with
    ``with_fp32`` also o32, o in fp32 over the unrounded probabilities
    (the kernels' third output, the backward's delta).

    The bias is ``rel_shift`` of the full q_v P^T, not the kernel's
    per-tile three-branch identity, so each checks the other. Products
    take the inputs' values in fp32; the probabilities, times the keep
    scale, are cast to v's dtype before P.V, as
    ``flash_attention_fwd_reference`` does.
    """
    with torch.autocast(q_u.device.type, enabled=False):
        s = _scores(q_u, q_v, k, p, sm_scale)
        keep = _keep(s.shape, dropout_rate, dropout_seed, s.device,
                     head_offset, heads_total)
        o, lse = masked_softmax_pv(s, v, k_len, q_u.dtype, keep=keep)
        if not with_fp32:
            return o, lse
        o32, _ = masked_softmax_pv(s, v, k_len, torch.float32, keep=keep,
                                   round_p=False)
        return o, lse, o32


def _bwd_terms(q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale,
               dropout_rate, dropout_seed, head_offset=0, heads_total=None):
    """(dS, P keep) in fp32, each rounded through the input dtype as the
    kernels cast it before its products: dS = P (dO V^T keep - delta)
    sm_scale with P = exp(s - lse) on valid keys."""
    s = _scores(q_u, q_v, k, p, sm_scale)
    valid = _valid_keys(s.shape[-2], s.shape[-1], k_len, False, s.device)
    prob = torch.where(valid, torch.exp(s - lse[..., None]),
                       torch.zeros((), device=s.device))
    dp_attn = torch.matmul(do.float(), v.float().transpose(-1, -2))
    p_kept = prob
    keep = _keep(s.shape, dropout_rate, dropout_seed, s.device, head_offset,
                 heads_total)
    if keep is not None:
        dp_attn = dp_attn * keep
        p_kept = prob * keep
    ds = prob * (dp_attn - delta[..., None]) * sm_scale
    return ds.to(q_u.dtype).float(), p_kept.to(do.dtype).float()


def flash_relpos_dq_reference(q_u, q_v, k, v, p, do, lse, delta, k_len,
                              sm_scale, dropout_rate=0.0, dropout_seed=0,
                              head_offset=0, heads_total=None):
    """Plain version of K5's dq kernel: dq_u = dS K, dq_v = G P with
    G = rel_shift_adjoint(dS) (q_v's shifted copy's share included)."""
    with torch.autocast(q_u.device.type, enabled=False):
        ds, _ = _bwd_terms(q_u, q_v, k, v, p, do, lse, delta, k_len,
                           sm_scale, dropout_rate, dropout_seed, head_offset,
                           heads_total)
        dq_u = torch.matmul(ds, k.float())
        dq_v = torch.matmul(rel_shift_adjoint(ds), p.float())
    return dq_u.to(q_u.dtype), dq_v.to(q_v.dtype)


def flash_relpos_dkdv_reference(q_u, q_v, k, v, p, do, lse, delta, k_len,
                                sm_scale, dropout_rate=0.0, dropout_seed=0,
                                head_offset=0, heads_total=None):
    """Plain version of K5's dk/dv/dP kernel: dk = dS^T q_u,
    dv = (P keep)^T dO, dP = sum_b G^T q_v."""
    with torch.autocast(q_u.device.type, enabled=False):
        ds, p_kept = _bwd_terms(q_u, q_v, k, v, p, do, lse, delta, k_len,
                                sm_scale, dropout_rate, dropout_seed,
                                head_offset, heads_total)
        dk = torch.matmul(ds.transpose(-1, -2), q_u.float())
        dv = torch.matmul(p_kept.transpose(-1, -2), do.float())
        dp = torch.einsum("bhij,bhid->hjd", rel_shift_adjoint(ds),
                          q_v.float())
    return dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype)


def flash_relpos_attention_bwd_reference(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    k_len: torch.Tensor, sm_scale: float, dropout_rate: float = 0.0,
    dropout_seed: int = 0, head_offset: int = 0,
    heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K5: (dq_u, dq_v, dk, dv, dp), dp (H, T, d)
    summed over the batch, in the inputs' dtypes.

    The formula of the TPU kernels written in tensors, not autograd: s
    recomputed with the full ``rel_shift``, P = exp(s - lse) on valid
    keys, dS = P (dO V^T keep - delta) sm_scale with delta = rowsum(dO O);
    dq_u = dS K, dk = dS^T q_u, dv = (P keep)^T dO; G =
    rel_shift_adjoint(dS), dq_v = G P, dp = sum_b G^T q_v. dS and P keep
    are cast to the input dtype before their products, as the TPU kernels
    do.
    """
    with torch.autocast(q_u.device.type, enabled=False):
        ds, p_kept = _bwd_terms(q_u, q_v, k, v, p, do, lse,
                                bwd_delta(o, do), k_len, sm_scale,
                                dropout_rate, dropout_seed, head_offset,
                                heads_total)
        g = rel_shift_adjoint(ds)
        dq_u = torch.matmul(ds, k.float())
        dq_v = torch.matmul(g, p.float())
        dk = torch.matmul(ds.transpose(-1, -2), q_u.float())
        dv = torch.matmul(p_kept.transpose(-1, -2), do.float())
        dp = torch.einsum("bhij,bhid->hjd", g, q_v.float())
    return (dq_u.to(q_u.dtype), dq_v.to(q_v.dtype), dk.to(k.dtype),
            dv.to(v.dtype), dp.to(p.dtype))


# ---- the kernel wrappers ----------------------------------------------------

def check_relpos_inputs(q_u, q_v, k, v, p, k_len):
    """Raise on what the kernels cannot take."""
    _check_cuda_inputs(q_u, k, v, k_len)
    b, h, t, d = q_u.shape
    if k.shape != q_u.shape:
        raise ValueError("flash_relpos_attention is self-attention only: "
                         f"q_u {tuple(q_u.shape)}, k {tuple(k.shape)}")
    if q_v.shape != q_u.shape or p.shape != (h, t, d):
        raise ValueError(f"q_v {tuple(q_v.shape)} must match q_u and p "
                         f"{tuple(p.shape)} must be {(h, t, d)}")
    for name, x in (("q_v", q_v), ("p", p)):
        if x.dtype != q_u.dtype:
            raise TypeError(f"{name} is {x.dtype}, q_u {q_u.dtype}")
        if x.device != q_u.device:
            raise ValueError(f"{name} is on {x.device}, q_u on {q_u.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_relpos_bwd_inputs(q_u, q_v, k, v, p, do, lse, delta, k_len):
    check_relpos_inputs(q_u, q_v, k, v, p, k_len)
    _check_bwd_inputs(q_u, k, v, do, lse, delta, k_len)


def _design(q_u, q_v, k, v, p, extra=()) -> str:
    """``select_design``'s choice for these inputs (no bias): "sm90" for
    bf16, d in SM90_HEAD_DIMS and 16-byte aligned inputs, else
    "simple"."""
    return select_design(q_u.dtype, False, q_u.shape[-1],
                         _aligned(q_u, q_v, k, v, p, *extra))


# ---- the kernel launches (CUDA tensors; called from the ops below) ------

def _no_o32(q_u):
    """The op's third output when o32 was not asked for."""
    return q_u.new_empty((0,), dtype=torch.float32)


def _forward_cuda(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
                  dropout_seed, design, head_offset=0, heads_total=0,
                  with_fp32=True):
    """(o, lse, o32) of K4 (rate 0) or K4-d launched on the card; o32
    empty and not computed unless ``with_fp32``. The design is
    ``select_design``'s; ``design="simple"`` forces the simple kernel in
    the Hopper design's mode (the same-run A/B's baseline)."""
    check_relpos_inputs(q_u, q_v, k, v, p, k_len)
    chosen = ("simple" if design == "simple"
              else _design(q_u, q_v, k, v, p))
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t, d = q_u.shape
    heads = _head_args(h, head_offset, heads_total)
    o = torch.empty_like(q_u)
    o32 = (torch.empty(q_u.shape, dtype=torch.float32, device=q_u.device)
           if with_fp32 else _no_o32(q_u))
    o32_ptr = o32.data_ptr() if with_fp32 else None
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q_u.device)
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        if chosen == "sm90":
            e = position_table(p)
            err = _sm90_fwd()(q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(),
                              v.data_ptr(), e.data_ptr(), k_len.data_ptr(),
                              o.data_ptr(), o32_ptr, lse.data_ptr(),
                              b, h, t, d,
                              float(sm_scale), flag, threshold, scale, seed,
                              *heads, stream)
        else:
            err = _kernel()(q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(),
                            v.data_ptr(), p.data_ptr(), k_len.data_ptr(),
                            o.data_ptr(), o32_ptr, lse.data_ptr(), b, h,
                            t, d,
                            float(sm_scale), flag, threshold, scale, seed,
                            *heads, _DTYPE_CODE[q_u.dtype], stream)
    _raise_on(err, SM90_KERNEL if chosen == "sm90" else KERNEL)
    counter = (("sm90_" if chosen == "sm90" else "")
               + ("dropout_launches" if flag else "launches"))
    setattr(flash_relpos_attention, counter,
            getattr(flash_relpos_attention, counter) + 1)
    return o, lse, o32


def _bwd_launch(name, args, outs, sm_scale, dropout_rate, dropout_seed,
                heads):
    q_u = args[0]
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t, d = q_u.shape
    heads = _head_args(h, *heads)
    fn = getattr(_bwd_kernels(), name)
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = fn(*(x.data_ptr() for x in args),
                 *(x.data_ptr() for x in outs), b, h, t, d,
                 float(sm_scale), flag, threshold, scale, seed, *heads,
                 _DTYPE_CODE[q_u.dtype], stream)
    _raise_on(err, name)


def _bwd_dq_cuda(args, sm_scale, dropout_rate, dropout_seed, heads=(0, 0)):
    """[dq_u, dq_v] of K5's simple dq kernel. The kernel writes q_v's own
    share and its shifted copy's share (dq_vs, row i standing for q_v row
    i + 1) in fp32; the second is added one row down, as JAX's pad and
    slice of ``q_vs`` do."""
    _check_relpos_bwd_inputs(*args)
    q_u, q_v = args[:2]
    dq_u = torch.empty_like(q_u)
    dq_v = torch.empty(q_v.shape, dtype=torch.float32, device=q_v.device)
    dq_vs = torch.empty_like(dq_v)
    _bwd_launch("flash_relpos_bwd_dq", args, (dq_u, dq_v, dq_vs), sm_scale,
                dropout_rate, dropout_seed, heads)
    flash_relpos_attention_bwd_dq.launches += 1
    dq_v[:, :, 1:] += dq_vs[:, :, :-1]
    return [dq_u, dq_v.to(q_v.dtype)]


def _bwd_dkdv_cuda(args, sm_scale, dropout_rate, dropout_seed,
                   heads=(0, 0)):
    """[dk, dv, dp] of K5's simple dk/dv/dP kernel: dP (H, T, d) summed
    over the batch in fp32 with atomics, cast to p's dtype."""
    _check_relpos_bwd_inputs(*args)
    k, v, p = args[2:5]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dp = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    _bwd_launch("flash_relpos_bwd_dkdv", args, (dk, dv, dp), sm_scale,
                dropout_rate, dropout_seed, heads)
    flash_relpos_attention_bwd_dkdv.launches += 1
    return [dk, dv, dp.to(p.dtype)]


def _bwd_sm90_cuda(args, sm_scale, dropout_rate, dropout_seed,
                   heads=(0, 0)):
    """[dq_u, dq_v, dk, dv, dp] of the Hopper design's fused K5; raises
    for inputs that design does not take. dq_u, dq_v and dE (the gradient
    of ``position_table``'s E, one plane per head that the whole batch adds
    into) are summed in zeroed fp32 accumulators with atomics, then
    cast."""
    _check_relpos_bwd_inputs(*args)
    q_u, q_v, k, v, p, do, lse, delta, k_len = args
    if _design(q_u, q_v, k, v, p, (do,)) != "sm90":
        raise ValueError("flash_relpos_attention_bwd_sm90 takes bf16, d in "
                         "(64, 96), 16-byte aligned inputs")
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t, d = q_u.shape
    heads = _head_args(h, *heads)
    e = position_table(p)
    f32 = dict(dtype=torch.float32, device=q_u.device)
    dqu_acc = torch.zeros(q_u.shape, **f32)
    dqv_acc = torch.zeros(q_u.shape, **f32)
    de_acc = torch.zeros(e.shape, **f32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = _sm90_bwd()(
            q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(), v.data_ptr(),
            e.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            k_len.data_ptr(), dqu_acc.data_ptr(), dqv_acc.data_ptr(),
            de_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
            float(sm_scale), flag, threshold, scale, seed, *heads, stream)
    _raise_on(err, SM90_BWD_KERNEL)
    flash_relpos_attention_bwd_sm90.launches += 1
    return [dqu_acc.to(q_u.dtype), dqv_acc.to(q_v.dtype), dk, dv,
            dp_from_table(de_acc).to(p.dtype)]


_BWD_KERNELS = {"dq": _bwd_dq_cuda, "dkdv": _bwd_dkdv_cuda,
                "sm90": _bwd_sm90_cuda}


def _bwd_cuda(q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale,
              dropout_rate, dropout_seed, kernel, head_offset=0,
              heads_total=0):
    """The K5 kernels from delta: with ``kernel="auto"`` those of
    ``select_design``'s choice, with "simple" the simple pair ([dq_u, dq_v,
    dk, dv, dp] in both cases); "dq", "dkdv" or "sm90" the one kernel of
    that name."""
    args = (q_u, q_v, k, v, p, do, lse, delta, k_len)
    kw = (sm_scale, dropout_rate, dropout_seed, (head_offset, heads_total))
    if kernel == "auto":
        kernel = ("sm90" if _design(q_u, q_v, k, v, p, (do,)) == "sm90"
                  else "simple")
    if kernel != "simple":
        return _BWD_KERNELS[kernel](args, *kw)
    return _bwd_dq_cuda(args, *kw) + _bwd_dkdv_cuda(args, *kw)


# ---- the custom ops ---------------------------------------------------------
#
# As in ops/flash_attention.py: every kernel of this file is reached through
# one op of the ``tts_port`` namespace, with a fake implementation, the
# plain version as its CPU implementation and the launch as its CUDA one.

def _fwd_cpu(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
             dropout_seed, design, head_offset=0, heads_total=0,
             with_fp32=True):
    out = _plain(flash_relpos_attention_fwd_reference(
        q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate, dropout_seed,
        *_head_args(q_u.shape[1], head_offset, heads_total),
        with_fp32=with_fp32))
    return tuple(out) if with_fp32 else (*out, _no_o32(q_u))


_relpos_fwd_op = torch.library.custom_op(
    "tts_port::relpos_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q_u, Tensor q_v, Tensor k, Tensor v, Tensor p, "
           "Tensor k_len, float sm_scale, float dropout_rate, "
           "int dropout_seed, str design, int head_offset=0, "
           "int heads_total=0, bool with_fp32=True) "
           "-> (Tensor, Tensor, Tensor)")(_fwd_cpu)
_relpos_fwd_op.register_kernel("cuda")(_forward_cuda)


@_relpos_fwd_op.register_fake
def _(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate, dropout_seed,
      design, head_offset=0, heads_total=0, with_fp32=True):
    return (torch.empty_like(q_u),
            q_u.new_empty(q_u.shape[:3], dtype=torch.float32),
            q_u.new_empty(q_u.shape, dtype=torch.float32) if with_fp32
            else _no_o32(q_u))


def _fwd_setup(ctx, inputs, output):
    (q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate, dropout_seed, _,
     head_offset, heads_total, _) = inputs
    _, lse, o32 = output
    ctx.save_for_backward(q_u, q_v, k, v, p, o32, lse, k_len)
    ctx.args = (sm_scale, dropout_rate, dropout_seed, head_offset,
                heads_total)
    ctx.mark_non_differentiable(lse, o32)


def _fwd_backward(ctx, do, _dlse, _do32):
    """Gradients for q_u, q_v, k, v and p from the backward op,
    recomputing P and the keep mask, delta from o32; none for k_len, the
    scale, the rate the seed or the heads, and none through lse or o32."""
    q_u, q_v, k, v, p, o, lse, k_len = ctx.saved_tensors
    sm_scale, dropout_rate, dropout_seed, head_offset, heads_total = ctx.args
    if o.shape != q_u.shape:
        raise RuntimeError("tts_port::relpos_fwd was called with "
                           "with_fp32=False: no o32 for the backward")
    grads = flash_relpos_attention_bwd(
        q_u, q_v, k, v, p, o, lse, do.to(q_u.dtype).contiguous(), k_len,
        sm_scale=sm_scale, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, head_offset=head_offset,
        heads_total=heads_total)
    return (*grads, None, None, None, None, None, None, None, None)


_relpos_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _bwd_cpu(q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale,
             dropout_rate, dropout_seed, kernel, head_offset=0,
             heads_total=0):
    args = (q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale,
            dropout_rate, dropout_seed,
            *_head_args(q_u.shape[1], head_offset, heads_total))
    out = []
    if kernel != "dkdv":
        out += flash_relpos_dq_reference(*args)
    if kernel != "dq":
        out += flash_relpos_dkdv_reference(*args)
    return _plain(out)


_relpos_bwd_op = torch.library.custom_op(
    "tts_port::relpos_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q_u, Tensor q_v, Tensor k, Tensor v, Tensor p, "
           "Tensor do, Tensor lse, Tensor delta, Tensor k_len, "
           "float sm_scale, float dropout_rate, int dropout_seed, "
           "str kernel, int head_offset=0, int heads_total=0) -> Tensor[]"
           )(_bwd_cpu)
_relpos_bwd_op.register_kernel("cuda")(_bwd_cuda)


@_relpos_bwd_op.register_fake
def _(q_u, q_v, k, v, p, do, lse, delta, k_len, sm_scale, dropout_rate,
      dropout_seed, kernel, head_offset=0, heads_total=0):
    grads = [torch.empty_like(x) for x in (q_u, q_v, k, v, p)]
    return {"dq": grads[:2], "dkdv": grads[2:]}.get(kernel, grads)


# ---- the public wrappers ----------------------------------------------------

def _forward(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
             dropout_seed, design=None, head_offset=0, heads_total=None):
    """(o, lse) through ``tts_port::relpos_fwd``: K4 (rate 0) or K4-d on
    the card, the plain version on the CPU. The op computes o32 only where
    autograd records it (grad mode on and an input that requires grad),
    and keeps it there for the backward. ``design="simple"`` forces the
    simple kernel in the Hopper design's mode (the same-run A/B's
    baseline); ``head_offset`` and ``heads_total`` as in
    ``flash_attention``."""
    with_fp32 = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q_u, q_v, k, v, p))
    o, lse, _ = _relpos_fwd_op(q_u, q_v, k, v, p, k_len, float(sm_scale),
                               float(dropout_rate), int(dropout_seed),
                               design or "auto", int(head_offset),
                               int(heads_total or 0), with_fp32)
    return o, lse


def _bwd_kernel(kernel, args, sm_scale, dropout_rate, dropout_seed,
                head_offset=0, heads_total=None):
    """The gradients of ``tts_port::relpos_bwd`` with ``kernel``."""
    return tuple(_relpos_bwd_op(*args, float(sm_scale), float(dropout_rate),
                                int(dropout_seed), kernel, int(head_offset),
                                int(heads_total or 0)))


def flash_relpos_attention_bwd_dq(q_u, q_v, k, v, p, do, lse, delta, k_len,
                                  *, sm_scale, dropout_rate=0.0,
                                  dropout_seed=0, head_offset=0,
                                  heads_total=None):
    """(dq_u, dq_v): K5's dq kernel on the card, its plain version on the
    CPU."""
    return _bwd_kernel("dq", (q_u, q_v, k, v, p, do, lse, delta, k_len),
                       sm_scale, dropout_rate, dropout_seed, head_offset,
                       heads_total)


def flash_relpos_attention_bwd_dkdv(q_u, q_v, k, v, p, do, lse, delta,
                                    k_len, *, sm_scale, dropout_rate=0.0,
                                    dropout_seed=0, head_offset=0,
                                    heads_total=None):
    """(dk, dv, dp): K5's dk/dv/dP kernel on the card, its plain version
    on the CPU. dP (H, T, d) is summed over the batch."""
    return _bwd_kernel("dkdv", (q_u, q_v, k, v, p, do, lse, delta, k_len),
                       sm_scale, dropout_rate, dropout_seed, head_offset,
                       heads_total)


flash_relpos_attention_bwd_dq.launches = 0
flash_relpos_attention_bwd_dkdv.launches = 0


def flash_relpos_attention_bwd_sm90(q_u, q_v, k, v, p, do, lse, delta,
                                    k_len, *, sm_scale, dropout_rate=0.0,
                                    dropout_seed=0, head_offset=0,
                                    heads_total=None
                                    ) -> Tuple[torch.Tensor, ...]:
    """(dq_u, dq_v, dk, dv, dp): the Hopper design's fused K5
    (csrc/flash_relpos_bwd_sm90.cu, bf16) on the card, the plain dq and
    dk/dv/dP on the CPU. dq_u, dq_v and dP come from fp32 atomics: unlike
    dk and dv they vary from run to run in their last bits."""
    return _bwd_kernel("sm90", (q_u, q_v, k, v, p, do, lse, delta, k_len),
                       sm_scale, dropout_rate, dropout_seed, head_offset,
                       heads_total)


flash_relpos_attention_bwd_sm90.launches = 0    # K5, the Hopper design


def flash_relpos_attention_bwd(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
    k_len: torch.Tensor, *, sm_scale: float, dropout_rate: float = 0.0,
    dropout_seed: int = 0, design: Optional[str] = None,
    head_offset: int = 0, heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dq_u, dq_v, dk, dv, dp) of ``flash_relpos_attention`` for the
    output gradient ``do``: delta, then ``tts_port::relpos_bwd`` -- on the
    card the kernels of ``select_design``'s choice, the Hopper design's
    fused K5 or the simple pair, K5's dq and dk/dv/dP kernels
    (``design="simple"`` forces the pair); the plain version on the
    CPU."""
    if o.shape != q_u.shape or o.dtype not in (q_u.dtype, torch.float32):
        raise ValueError(f"o must match q_u, or be its fp32 o32: "
                         f"{tuple(o.shape)} {o.dtype}")
    return _bwd_kernel(design or "auto",
                       (q_u, q_v, k, v, p, do, lse, bwd_delta(o, do), k_len),
                       sm_scale, dropout_rate, dropout_seed, head_offset,
                       heads_total)


def flash_relpos_attention(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, k_len: torch.Tensor, *, sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0, dropout_seed: int = 0, head_offset: int = 0,
    heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of relative-position self-attention.

    q_u, q_v, k, v (B, H, T, d) of one dtype; p (H, T, d); ``k_len`` (B,)
    int32 valid keys per batch row; ``sm_scale`` defaults to 1/sqrt(d).
    ``dropout_rate`` > 0 drops attention probabilities with the hash
    seeded by ``dropout_seed`` (an int32; the backward rebuilds the same
    mask); ``head_offset`` and ``heads_total`` place the tensor's heads
    among a model's for the hash, as in ``flash_attention``. ``o`` has
    q_u's dtype and carries gradients to q_u, q_v, k, v and p (the
    backward op); ``lse`` (B, H, T) is fp32 and carries none.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q_u.shape[-1])
    return _forward(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
                    dropout_seed, head_offset=head_offset,
                    heads_total=heads_total)


flash_relpos_attention.launches = 0             # K4
flash_relpos_attention.dropout_launches = 0     # K4-d
flash_relpos_attention.sm90_launches = 0        # K4, the Hopper design
flash_relpos_attention.sm90_dropout_launches = 0  # K4-d, the Hopper design


def _kernel():
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = cuda_build.load(KERNEL).flash_relpos_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernels():
    from transformer_tts_tpu_torch.ops import cuda_build
    lib = cuda_build.load(BWD_KERNEL)
    tail = ([ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
               ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p])
    for name in ("flash_relpos_bwd_dq", "flash_relpos_bwd_dkdv"):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * (9 + 3) + tail
            fn.restype = ctypes.c_int
    return lib


def _sm90_entry(name: str, pointers: int):
    """The Hopper design's entry point ``name`` (its library built on first
    use): ``pointers`` device pointers, then B, H, T and d, then the
    scale, the dropout flag, threshold, keep scale and seed, the hash's
    head offset and heads total, and the stream."""
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _sm90_fwd():    # q_u, q_v, k, v, e, k_len, o, o32 (nullable), lse
    return _sm90_entry(SM90_KERNEL, 9)


def _sm90_bwd():    # q_u, q_v, k, v, e, do, lse, delta, k_len, dq_u, dq_v,
    # dE accumulators, dk, dv
    return _sm90_entry(SM90_BWD_KERNEL, 14)
