"""Relative-position flash-attention forward: the hand-written Hopper kernel
and its plain version.

``flash_relpos_attention`` replaces the TPU kernel ``_fwd_kernel`` driven
by ``_relpos_fwd`` (transformer_tts_tpu/ops/flash_relpos.py:212-322), the
conformer's Transformer-XL self-attention. It computes

    s   = (q_u k^T + rel_shift(q_v P^T)) * sm_scale, keys c < k_len[b]
    o   = softmax(s) v
    lse = row logsumexp of s (fp32)

with P (H, T, d) the projected position table shared over the batch,
without writing the (B, H, T, T) logits or the bias to device memory.
Keys at or past ``k_len[b]`` are excluded exactly; a row with no valid
key gives o = 0 and lse = -1e30, as K1 (ops/flash_attention.py) does.

``rel_shift`` is the reference's pad-and-reshape shift. On one tile the
kernel builds its result from the three-branch identity instead
(transformer_tts_tpu/ops/flash_relpos.py:17-23):

    bd[i, j] = q_v[i]   . P[T-1-(i-j)]   for j <= i
             = 0                         for j == i+1
             = q_v[i+1] . P[j-i-2]       for j >= i+2

Kernel: ``csrc/flash_relpos_fwd.cu``, CUDA C++ for sm_90a, fp32 and bf16.
Its bound on an H100 is the tensor-core rate: 6*H*T*sum(k_len)*d
operations (q_u.K^T, q_v.P^T and P.V over the valid keys) over
989 TFLOP/s in bf16, against q_u, q_v, k, v, o and P moved once over
3.35 TB/s. PERF.md holds its measured times.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from transformer_tts_tpu_torch.ops.flash_attention import (
    _DTYPE_CODE, _check_cuda_inputs, masked_softmax_pv)

KERNEL = "flash_relpos_fwd"


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Transformer-XL relative shift of (B, H, T_q, T_pos) scores
    (the port of transformer_tts_tpu/ops/attention.py:204-213)."""
    b, h, t1, t2 = x.shape
    padded = torch.cat([x.new_zeros(b, h, t1, 1), x], dim=-1)
    return padded.reshape(b, h, t2 + 1, t1)[:, :, 1:].reshape(b, h, t1, t2)


def flash_relpos_attention_fwd_reference(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, k_len: torch.Tensor, sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same (o, lse).

    The bias is ``rel_shift`` of the full q_v P^T, not the kernel's
    per-tile three-branch identity, so each checks the other. Products
    take the inputs' values in fp32; the probabilities are cast to v's
    dtype before P.V, as ``flash_attention_fwd_reference`` does.
    """
    with torch.autocast(q_u.device.type, enabled=False):
        ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
        bd = rel_shift(torch.matmul(q_v.float(),
                                    p.float().transpose(-1, -2)))
        return masked_softmax_pv((ac + bd) * sm_scale, v, k_len, q_u.dtype)


def check_relpos_inputs(q_u, q_v, k, v, p, k_len):
    """Raise on what the kernel cannot take."""
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


def flash_relpos_attention(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, k_len: torch.Tensor, *, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of relative-position self-attention.

    q_u, q_v, k, v (B, H, T, d) of one dtype; p (H, T, d); ``k_len`` (B,)
    int32 valid keys per batch row; ``sm_scale`` defaults to 1/sqrt(d).
    ``o`` has q_u's dtype, ``lse`` (B, H, T) is fp32.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q_u.shape[-1])
    if q_u.device.type == "cpu":
        return flash_relpos_attention_fwd_reference(q_u, q_v, k, v, p, k_len,
                                                    sm_scale)
    if q_u.device.type != "cuda":
        raise ValueError(f"flash_relpos_attention runs on cpu or cuda, "
                         f"not {q_u.device}")
    check_relpos_inputs(q_u, q_v, k, v, p, k_len)
    b, h, t, d = q_u.shape
    o = torch.empty_like(q_u)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q_u.device)
    with torch.cuda.device(q_u.device):
        stream = torch.cuda.current_stream(q_u.device).cuda_stream
        err = _kernel()(q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(),
                        v.data_ptr(), p.data_ptr(), k_len.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), b, h, t, d,
                        float(sm_scale), _DTYPE_CODE[q_u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with cudaError {err}")
    flash_relpos_attention.launches += 1
    return o, lse


flash_relpos_attention.launches = 0


def _kernel():
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = cuda_build.load(KERNEL).flash_relpos_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
