"""Flash-attention forward: the hand-written Hopper kernel and its plain version.

``flash_attention`` replaces the TPU kernel ``_fwd_kernel`` driven by
``_flash_fwd`` (transformer_tts_tpu/ops/flash_attention.py:90-263) on the
path synthesis runs: non-causal, no bias, no dropout. It computes

    o   = softmax(q k^T * sm_scale, keys c < k_len[b]) v
    lse = row logsumexp of the masked, scaled logits (fp32)

without writing the (B, H, T_q, T_k) scores to device memory. Keys at or
past ``k_len[b]`` are excluded exactly; a row with no valid key gives
o = 0 and lse = -1e30 (the TPU kernel's convention; the masked-fill path
of ``ops/attention.scaled_dot_attention`` gives the uniform average there
instead, on query rows that only padding reads).

Kernel: ``csrc/flash_attention_fwd.cu``, CUDA C++ for sm_90a, fp32 and
bf16. Its bound on an H100 is the tensor-core rate: 4*B*H*T_q*T_k*d
operations over 989 TFLOP/s (bf16) against Q, K, V and O moved once over
3.35 TB/s, ~0.9 us at (1, 4, 768, 96) and ~52 us at (8, 4, 2048, 96).
Design: one 128-thread block per 64 query rows of one batch-head, a loop
over 64-key tiles staged in shared memory, fp32 running max, sum and
accumulator, WMMA tensor-core products for bf16 and FMA products for fp32;
see the source for the details. PERF.md holds its measured times.

On a CPU tensor the wrapper computes the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL = "flash_attention_fwd"
MAX_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    sm_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: the same (o, lse).

    Products take the inputs' values in fp32 (a bf16 product is exact in
    fp32) and the probabilities are cast to the value dtype before P.V, as
    the TPU kernel and ``reference_attention`` do.
    """
    with torch.autocast(q.device.type, enabled=False):
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
        return masked_softmax_pv(s, v, k_len, q.dtype)


def masked_softmax_pv(
    s: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) from fp32 scaled logits ``s`` (B, H, T_q, T_k): keys at or
    past ``k_len[b]`` excluded exactly, a row with no valid key giving
    o = 0 and lse = -1e30. Shared by the kernels' plain versions."""
    valid = (torch.arange(s.shape[-1], device=s.device)[None, :]
             < k_len.to(s.device)[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones((), device=s.device))
    p = (p / safe_l).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(out_dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return o, lse


def _check_cuda_inputs(q, k, v, k_len):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, H, T, d)")
    b, h, t_q, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d > MAX_HEAD_DIM or d % 8 != 0:
        raise ValueError(f"head dim {d} unsupported: need d <= "
                         f"{MAX_HEAD_DIM} and d % 8 == 0")
    if t_q == 0 or k.shape[2] == 0 or b * h > 65535:
        raise ValueError(f"unsupported sizes B*H={b * h}, T_q={t_q}, "
                         f"T_k={k.shape[2]}")
    if k_len.shape != (b,) or k_len.dtype != torch.int32:
        raise ValueError("k_len must be an int32 tensor of shape (B,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("k_len", k_len)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    *, sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of masked attention; q (B,H,T_q,d), k/v (B,H,T_k,d).

    ``k_len`` (B,) int32 is the number of valid keys per batch row;
    ``sm_scale`` defaults to 1/sqrt(d). ``o`` has q's dtype, ``lse``
    (B, H, T_q) is fp32.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, k_len, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, "
                         f"not {q.device}")
    _check_cuda_inputs(q, k, v, k_len)
    b, h, t_q, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        k_len.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        b, h, t_q, k.shape[2], d, float(sm_scale),
                        _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed with cudaError {err}")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0


def _kernel():
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = cuda_build.load(KERNEL).flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
