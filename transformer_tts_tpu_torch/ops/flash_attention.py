"""Flash attention: the hand-written Hopper kernels and their plain versions.

The port of transformer_tts_tpu/ops/flash_attention.py: a prefix key mask
given as ``k_len``, optionally causal, optionally an additive bias on the
logits (``flash_attention_with_bias``, non-causal), and attention-prob
dropout from a counter hash.

    o   = (softmax((q k^T [+ bias]) * sm_scale, keys c < k_len[b]
                   [and c <= r with causal]) * keep) v
    lse = row logsumexp of the masked, scaled logits (fp32)

``causal`` masks in global, top-left-aligned indices (query row r sees
keys c <= r, T_q != T_k allowed), as the TPU kernels do; a padded query
row (r >= k_len[b]) still sees every valid key.

``keep`` is ``keep_mask``: a murmur3 hash of the global (batch-head, query,
key) coordinates and a per-call seed, kept with probability 1 - rate and
scaled by 1/(1 - rate); the softmax normaliser sums the probabilities
before dropout. The batch-head hashed for head h of batch row b is
b * heads_total + head_offset + h: the tensor's own b * H + h by default,
and under tensor parallelism (parallel/tp.py), where a rank holds heads
[head_offset, head_offset + H) of the model's heads_total, the unsharded
model's, so each rank draws its slice of the unsharded mask. Keys at or past ``k_len[b]`` are excluded exactly; a row
with no valid key gives o = 0 and lse = -1e30 (the TPU kernel's
convention; the masked-fill path of ``ops/attention.scaled_dot_attention``
gives the uniform average there instead, on query rows that only padding
reads).

Kernels, CUDA C++ for sm_90a in fp32 and bf16, bound by the tensor-core
rate at the decoder's shapes:

* K1 and K1-d, ``csrc/flash_attention_fwd.cu``: the forward
  (``_fwd_kernel``, :90-174), without and with dropout. 4*H*T_q*sum(k_len)*d
  operations against Q, K, V and O moved once.
* K2, ``csrc/flash_attention_bwd.cu``: the FlashAttention-2 backward
  (``_dq_kernel`` :266, ``_dkdv_kernel`` :344), P rebuilt from lse and the
  keep mask from the hash, ``delta = rowsum(dO*O)`` a torch reduction as in
  ``_flash_bwd``. 10*H*T_q*sum(k_len)*d operations (five products) against
  Q, K, V, O, dO, dQ, dK and dV moved once.
* K3, the causal mode of the same two sources (``causal=True``, :138-143,
  :306-310, :379-383): the element mask gains c <= r, the forward and dq
  stop their key-tile loops at the diagonal tile (the block skips at
  :161-165 and :329-335), dk/dv starts its q-tile loop at the tile holding
  row k0 (:406-407). The work is counted per valid (row, key) pair,
  sum_b sum_r min(r + 1, k_len[b]), about half of the non-causal count.
* K6 and K6-d, the ``bias`` argument of the same two sources (``has_bias``:
  :101-106 and :132-134 of ``_fwd_kernel``, :277-281, :301-302 and
  :323-334 of ``_dq_kernel``, :349-353 and :374-375 of ``_dkdv_kernel``;
  the VJP ``_flash_b`` :585-614 of ``flash_attention_with_bias``
  :655-677): a (B, H, T_q, T_k) bias in q's dtype added to q k^T in fp32
  before the scale; the dq kernel also writes dbias = dS (the pre-scale
  logit gradient, in the bias's dtype, exactly 0 past ``k_len`` and on
  every tile it skips). Bound by the bytes of the bias read over the
  valid keys and, in the backward, the dbias written.

Design of both: one 128-thread block per 64-row tile and batch-head, a loop
over 64-row tiles of the other sequence staged in shared memory, fp32
statistics and accumulators, WMMA tensor-core products for bf16 and FMA
products for fp32; see the sources. PERF.md holds their measured times.

Every bf16 mode at d in ``SM90_HEAD_DIMS`` with 16-byte aligned inputs --
causal or not, with a bias or not (a bias also needs T_k % 8 == 0) -- has
a second design written for Hopper (``select_design`` picks it; nothing
falls back from one to the other):

* K1 and K1-d, with ``causal`` K3-f and K3-d, with a bias K6 and K6-d,
  ``csrc/flash_fwd_sm90.cu``: TMA loads into a ring of mbarrier-guarded
  stages, a producer warpgroup and two consumer warpgroups, ``wgmma``
  products with the softmax and O in registers; causal, each warpgroup
  stops at its diagonal key tile; the bias tile comes by TMA with its
  K/V stage and is added to S from shared memory.
* K2, with ``causal`` K3's backward, with a bias K6's,
  ``csrc/flash_bwd_sm90.cu``: one fused kernel per 128 keys, five products
  per tile pair, dK and dV in registers, dq summed with fp32 atomics into
  a zeroed accumulator (``flash_attention_bwd_sm90``); causal, the q-tile
  loop starts at the tile holding the block's first key; with a bias,
  dbias = dS goes out through a shared-memory tile by TMA store, each
  element once, with no atomics.

fp32, other head dims and a bias whose T_k is not a multiple of 8 stay on
the simple design, which also stays reachable for the same-run A/B
(``design="simple"``).

Every kernel is reached through a ``torch.library`` custom op of the
``tts_port`` namespace: ``tts_port::flash_fwd`` (K1/K1-d, K3-f/K3-d,
K6/K6-d, both designs) and ``tts_port::flash_bwd`` (from delta, the
backward of ``select_design``'s choice, the simple pair, or one kernel:
the simple dq, the simple dk/dv or the fused Hopper one). Each has a fake implementation (shapes and dtypes only), so ``torch.export``
traces through it; its CPU implementation is the plain version and its
CUDA one the launch, which picks the design and checks alignment where the
tensors are real. ``flash_attention`` is differentiable in q, k and v,
``flash_attention_with_bias`` in q, k, v and the bias, through the forward
op's registered autograd. On a CPU tensor every wrapper computes the
plain version; on a CUDA tensor it launches its kernel or raises. The
launch counts are ``flash_attention.launches`` (K1), ``.dropout_launches``
(K1-d), ``.sm90_launches`` and ``.sm90_dropout_launches`` (the Hopper
design's K1 and K1-d), ``.causal_launches`` (K3's forward at rate 0, K3-f) and
``.causal_dropout_launches`` (K3-d), ``.sm90_causal_launches`` and
``.sm90_causal_dropout_launches`` (the Hopper design's K3-f and K3-d);
``flash_attention_bwd_dq.launches``
and ``flash_attention_bwd_dkdv.launches`` (K2), the same functions'
``.causal_launches`` (K3's dq and dk/dv) and ``.bias_launches`` (K6's dq
and dbias, K6's dk/dv); ``flash_attention_bwd_sm90.launches`` (the Hopper
design's fused K2), ``.causal_launches`` (its fused K3 backward) and
``.bias_launches`` (its fused K6 backward);
``flash_attention_with_bias.launches`` (K6) and
``.dropout_launches`` (K6-d), ``.sm90_launches`` and
``.sm90_dropout_launches`` (the Hopper design's K6 and K6-d).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e30
KERNEL = "flash_attention_fwd"
BWD_KERNEL = "flash_attention_bwd"
SM90_KERNEL = "flash_fwd_sm90"
SM90_BWD_KERNEL = "flash_bwd_sm90"
MAX_HEAD_DIM = 128
SM90_HEAD_DIMS = (64, 96)       # head dims the Hopper design takes

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_U32 = 0xFFFFFFFF


# ---- the dropout hash -------------------------------------------------------

def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 ``x`` in [0, 2^32): the product is split
    in 16-bit halves so that no int64 product overflows."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _U32


def keep_bits(seed: int, bh, row, col, dropout_rate: float) -> torch.Tensor:
    """Bool keep mask of the counter hash, broadcast over the int64 tensors
    ``bh``, ``row`` and ``col`` (global batch-head, query and key indices).

    x = seed + bh*0x9E3779B9 + row*0x85EBCA6B + col*0xC2B2AE35, then
    murmur3 fmix32, all in uint32 arithmetic (int64 masked to 32 bits, as
    torch's int32 ``>>`` is arithmetic); kept iff x >= int(rate * 2^32).
    The kernels' copy, shared by K1-d and K2, is ``keep_bit`` in
    ``csrc/flash_common.cuh``.
    """
    x = (int(seed) & _U32) + _mul_u32(bh, 0x9E3779B9)
    x = (x + _mul_u32(row, 0x85EBCA6B)) & _U32
    x = (x + _mul_u32(col, 0xC2B2AE35)) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= int(dropout_rate * (2 ** 32))


def keep_mask(seed: int, bh: int, q_offset: int, k_offset: int, shape,
              dropout_rate: float, device=None) -> torch.Tensor:
    """The (keep / (1 - rate)) fp32 tile of ``shape`` = (rows, cols) whose
    first element is (q_offset, k_offset): the port of ``_keep_mask``."""
    rows = torch.arange(shape[0], dtype=torch.int64, device=device)
    cols = torch.arange(shape[1], dtype=torch.int64, device=device)
    bh = torch.tensor(int(bh), dtype=torch.int64, device=device)
    keep = keep_bits(seed, bh, (q_offset + rows)[:, None],
                     (k_offset + cols)[None, :], dropout_rate)
    return keep.to(torch.float32) / (1.0 - dropout_rate)


def hash_heads(b: int, h: int, head_offset: int = 0,
               heads_total: Optional[int] = None, device=None
               ) -> torch.Tensor:
    """(B, H) int64 batch-heads the dropout hash reads for a tensor of H
    heads that holds heads [head_offset, head_offset + H) of
    ``heads_total`` (default H): b * heads_total + head_offset + h, the
    kernels' ``hash_head`` (csrc/flash_common.cuh)."""
    head_offset, total = _head_args(h, head_offset, heads_total)
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None]
    heads = torch.arange(h, dtype=torch.int64, device=device)[None, :]
    return rows * total + head_offset + heads


def _full_keep_mask(b: int, h: int, t_q: int, t_k: int, seed: int,
                    dropout_rate: float, device, head_offset: int = 0,
                    heads_total: Optional[int] = None) -> torch.Tensor:
    """(B, H, T_q, T_k) keep scale at the batch-heads of ``hash_heads``."""
    bh = hash_heads(b, h, head_offset, heads_total, device)
    rows = torch.arange(t_q, dtype=torch.int64, device=device)
    cols = torch.arange(t_k, dtype=torch.int64, device=device)
    keep = keep_bits(seed, bh.view(b, h, 1, 1), rows.view(t_q, 1),
                     cols.view(1, t_k), dropout_rate)
    return keep.to(torch.float32) / (1.0 - dropout_rate)


def _head_args(h: int, head_offset: int, heads_total: Optional[int]):
    """(head_offset, heads_total) as the kernels take them, checked; a
    heads_total of None or 0 stands for the tensor's H."""
    total = int(heads_total) if heads_total else h
    if not 0 <= head_offset <= total - h:
        raise ValueError(f"heads [{head_offset}, {head_offset + h}) are "
                         f"not heads of {total}")
    return int(head_offset), total


def _dropout_args(dropout_rate: float, dropout_seed: int):
    """(flag, threshold, keep scale, seed) as the kernels take them: the
    threshold int(rate * 2^32) as JAX computes it, the scale 1/(1-rate) in
    fp32 and the int32 seed as its uint32 bits."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} outside [0, 1)")
    if dropout_rate == 0.0:
        return 0, 0, 1.0, 0
    scale = float(np.float32(1.0) / np.float32(1.0 - dropout_rate))
    return (1, int(dropout_rate * (2 ** 32)), scale,
            int(dropout_seed) & _U32)


# ---- plain versions ---------------------------------------------------------

def _valid_keys(t_q: int, t_k: int, k_len: torch.Tensor, causal: bool,
                device) -> torch.Tensor:
    """(B, 1, 1, T_k) bool, True for keys c < k_len[b]; with ``causal``
    (B, 1, T_q, T_k), also c <= r for query row r."""
    cols = torch.arange(t_k, device=device)
    valid = (cols[None, :] < k_len.to(device)[:, None])[:, None, None, :]
    if causal:
        rows = torch.arange(t_q, device=device)
        valid = valid & (cols[None, :] <= rows[:, None])[None, None]
    return valid


def _logits(q, k, bias, sm_scale):
    """(q k^T + bias) * sm_scale in fp32, the bias (if any) added before
    the scale as ``_fwd_kernel`` does."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    return s * sm_scale


def flash_attention_fwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    sm_scale: float, dropout_rate: float = 0.0, dropout_seed: int = 0,
    causal: bool = False, bias: Optional[torch.Tensor] = None,
    head_offset: int = 0, heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 and K1-d, with ``causal`` of K3's
    forward and with ``bias`` of K6 and K6-d: the same (o, lse); the keep
    mask at the batch-heads of ``hash_heads``.

    Products take the inputs' values in fp32 (a bf16 product is exact in
    fp32) and the probabilities, times the keep scale, are cast to the
    value dtype before P.V, as the TPU kernel and ``reference_attention``
    do.
    """
    with torch.autocast(q.device.type, enabled=False):
        s = _logits(q, k, bias, sm_scale)
        keep = None
        if dropout_rate > 0.0:
            b, h, t_q, t_k = s.shape
            keep = _full_keep_mask(b, h, t_q, t_k, dropout_seed,
                                   dropout_rate, s.device, head_offset,
                                   heads_total)
        return masked_softmax_pv(s, v, k_len, q.dtype, keep=keep,
                                 causal=causal)


def masked_softmax_pv(
    s: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    out_dtype: torch.dtype, keep: Optional[torch.Tensor] = None,
    causal: bool = False, round_p: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) from fp32 scaled logits ``s`` (B, H, T_q, T_k): keys at or
    past ``k_len[b]`` (and with ``causal`` past the row) excluded exactly,
    a row with no valid key giving o = 0 and lse = -1e30; ``keep`` (the
    dropout scale) multiplies the normalised probabilities, which are cast
    to v's dtype before P.V unless ``round_p`` is False. Shared by the
    kernels' plain versions."""
    valid = _valid_keys(s.shape[-2], s.shape[-1], k_len, causal, s.device)
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=s.device))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones((), device=s.device))
    p = p / safe_l
    if keep is not None:
        p = p * keep
    if round_p:
        p = p.to(v.dtype).float()
    o = torch.matmul(p, v.float()).to(out_dtype)
    lse = (m + torch.log(safe_l))[..., 0]
    return o, lse


def _bwd_terms(q, k, v, do, lse, delta, k_len, sm_scale, dropout_rate,
               dropout_seed, causal, bias=None, head_offset=0,
               heads_total=None):
    """(dS, P keep) in fp32, each rounded through the dtype the TPU kernels
    cast it to before its products (q's and dO's). dS is also K6's dbias,
    the gradient of the pre-scale logits: 0 wherever P is."""
    with torch.autocast(q.device.type, enabled=False):
        s = _logits(q, k, bias, sm_scale)
        valid = _valid_keys(s.shape[-2], s.shape[-1], k_len, causal,
                            s.device)
        p = torch.where(valid, torch.exp(s - lse[..., None]),
                        torch.zeros((), device=s.device))
        dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
        p_kept = p
        if dropout_rate > 0.0:
            b, h, t_q, t_k = s.shape
            keep = _full_keep_mask(b, h, t_q, t_k, dropout_seed,
                                   dropout_rate, s.device, head_offset,
                                   heads_total)
            dp = dp * keep
            p_kept = p * keep
        ds = p * (dp - delta[..., None]) * sm_scale
        return ds.to(q.dtype).float(), p_kept.to(do.dtype).float()


def bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, H, T_q): the torch reduction that
    ``_flash_bwd`` leaves to XLA."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_attention_dq_reference(q, k, v, do, lse, delta, k_len, sm_scale,
                                 dropout_rate=0.0, dropout_seed=0,
                                 causal=False, bias=None, head_offset=0,
                                 heads_total=None):
    """Plain version of K2's (with ``causal`` K3's) dq kernel: dq = dS K;
    with ``bias``, K6's: (dq, dbias = dS in the bias's dtype)."""
    ds, _ = _bwd_terms(q, k, v, do, lse, delta, k_len, sm_scale,
                       dropout_rate, dropout_seed, causal, bias,
                       head_offset, heads_total)
    with torch.autocast(q.device.type, enabled=False):
        dq = torch.matmul(ds, k.float()).to(q.dtype)
    return dq if bias is None else (dq, ds.to(bias.dtype))


def flash_attention_dkdv_reference(q, k, v, do, lse, delta, k_len, sm_scale,
                                   dropout_rate=0.0, dropout_seed=0,
                                   causal=False, bias=None, head_offset=0,
                                   heads_total=None):
    """Plain version of K2's (with ``causal`` K3's, with ``bias`` K6's)
    dk/dv kernel: dk = dS^T Q, dv = (P keep)^T dO."""
    ds, p_kept = _bwd_terms(q, k, v, do, lse, delta, k_len, sm_scale,
                            dropout_rate, dropout_seed, causal, bias,
                            head_offset, heads_total)
    with torch.autocast(q.device.type, enabled=False):
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        dv = torch.matmul(p_kept.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, k_len: torch.Tensor,
    sm_scale: float, dropout_rate: float = 0.0, dropout_seed: int = 0,
    causal: bool = False, bias: Optional[torch.Tensor] = None,
    head_offset: int = 0, heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K2 (with ``causal`` of K3's backward):
    (dq, dk, dv) in the inputs' dtypes; with ``bias`` of K6's backward:
    (dq, dk, dv, dbias), dbias in the bias's dtype.

    The formula of ``_dq_kernel``/``_dkdv_kernel`` written in tensors, not
    autograd: P = exp(S - lse) on valid keys (S with the bias added before
    the scale), dP = dO V^T times the keep scale, delta = rowsum(dO*O) in
    fp32, dS = P (dP - delta) sm_scale; dq = dS K, dk = dS^T Q, dv = (P
    keep)^T dO, dbias = dS, with dS and P keep cast to the input dtype
    before their products, as the TPU kernels do.
    """
    ds, p_kept = _bwd_terms(q, k, v, do, lse, bwd_delta(o, do), k_len,
                            sm_scale, dropout_rate, dropout_seed, causal,
                            bias, head_offset, heads_total)
    with torch.autocast(q.device.type, enabled=False):
        dq = torch.matmul(ds, k.float())
        dk = torch.matmul(ds.transpose(-1, -2), q.float())
        dv = torch.matmul(p_kept.transpose(-1, -2), do.float())
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    return grads if bias is None else (*grads, ds.to(bias.dtype))


# ---- the kernel wrappers ----------------------------------------------------

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


def _check_bwd_inputs(q, k, v, do, lse, delta, k_len):
    _check_cuda_inputs(q, k, v, k_len)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do must match q: {tuple(do.shape)} {do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape (B, H, T_q)")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def check_bias(q: torch.Tensor, k: torch.Tensor,
               bias: torch.Tensor) -> None:
    """K6's bias: contiguous, on q's device, in q's dtype, of shape
    (B, H, T_q, T_k); no broadcasting, as in the JAX package."""
    want = (*q.shape[:3], k.shape[2])
    if tuple(bias.shape) != want:
        raise ValueError(f"bias must be (B, H, T_q, T_k) = {want}, not "
                         f"{tuple(bias.shape)}")
    if bias.dtype != q.dtype:
        raise TypeError(f"bias is {bias.dtype}, q {q.dtype}")
    if bias.device != q.device:
        raise ValueError(f"bias is on {bias.device}, q on {q.device}")
    if not bias.is_contiguous():
        raise ValueError("bias must be contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {err}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def select_design(dtype: torch.dtype, has_bias: bool, d: int,
                  aligned: bool = True) -> str:
    """The kernel design for a mode on the card: "sm90" (flash_fwd_sm90.cu
    and flash_bwd_sm90.cu) for bf16, d in ``SM90_HEAD_DIMS`` and inputs
    laid out for TMA (``aligned``: 16-byte aligned bases and, for a bias,
    a row stride of a multiple of 16 bytes, so T_k % 8 == 0 in bf16),
    causal (K3) or not, with a bias (K6) or not; "simple"
    (flash_attention_fwd.cu and flash_attention_bwd.cu) for every other
    mode: fp32, another d, inputs TMA cannot map."""
    if dtype == torch.bfloat16 and d in SM90_HEAD_DIMS and aligned:
        return "sm90"
    return "simple"


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _design(q, k, v, bias, extra=()) -> str:
    held = (q, k, v, *extra) + (() if bias is None else (bias,))
    rows = bias is None or bias.stride(-2) * bias.element_size() % 16 == 0
    return select_design(q.dtype, bias is not None, q.shape[-1],
                         rows and _aligned(*held))


# ---- the kernel launches (CUDA tensors; called from the ops below) ------

def _forward_cuda(q, k, v, k_len, bias, sm_scale, dropout_rate, dropout_seed,
                  causal, design, head_offset=0, heads_total=0):
    """(o, lse) of K1 (rate 0) or K1-d, with ``causal`` K3-f or K3-d, with
    ``bias`` K6 or K6-d, launched on the card. The design is
    ``select_design``'s; ``design="simple"`` forces the simple kernel in the
    Hopper design's mode (the same-run A/B's baseline)."""
    _check_cuda_inputs(q, k, v, k_len)
    if bias is not None:
        check_bias(q, k, bias)
    chosen = ("simple" if design == "simple"
              else _design(q, k, v, bias))
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t_q, d = q.shape
    heads = _head_args(h, head_offset, heads_total)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if chosen == "sm90":
            err = _sm90_fwd()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                k_len.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, t_q,
                k.shape[2], d, float(sm_scale), flag, threshold, scale, seed,
                int(causal), *heads, stream)
        else:
            err = _fwd_kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                _ptr(bias), k_len.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), b, h, t_q, k.shape[2], d,
                                float(sm_scale), flag, threshold, scale,
                                seed, int(causal), *heads,
                                _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, SM90_KERNEL if chosen == "sm90" else KERNEL)
    wrapper = flash_attention if bias is None else flash_attention_with_bias
    counter = (("sm90_" if chosen == "sm90" else "")
               + ("causal_" if causal else "")
               + ("dropout_launches" if flag else "launches"))
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    return o, lse


def _bwd_launch(name, q, k, v, bias, do, lse, delta, k_len, outs, sm_scale,
                dropout_rate, dropout_seed, causal, heads):
    """Launch one backward kernel; ``outs`` may hold None (no dbias)."""
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t_q, d = q.shape
    heads = _head_args(h, *heads)
    fn = getattr(_bwd_kernels(), name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 k_len.data_ptr(), *(_ptr(x) for x in outs), b, h, t_q,
                 k.shape[2], d, float(sm_scale), flag, threshold, scale,
                 seed, int(causal), *heads, _DTYPE_CODE[q.dtype], stream)
    _raise_on(err, name)


def _count_bwd(wrapper, bias, causal):
    """One more launch on the backward wrapper's counter for its mode."""
    counter = ("bias_launches" if bias is not None
               else "causal_launches" if causal else "launches")
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _bwd_dq_cuda(q, k, v, do, lse, delta, k_len, bias, sm_scale,
                 dropout_rate, dropout_seed, causal, heads=(0, 0)):
    """[dq] (with ``bias`` [dq, dbias]) of the simple dq kernel."""
    _check_bwd_inputs(q, k, v, do, lse, delta, k_len)
    dq = torch.empty_like(q)
    dbias = None
    if bias is not None:
        check_bias(q, k, bias)
        dbias = torch.empty_like(bias)
    _bwd_launch("flash_attention_bwd_dq", q, k, v, bias, do, lse, delta,
                k_len, (dq, dbias), sm_scale, dropout_rate, dropout_seed,
                causal, heads)
    _count_bwd(flash_attention_bwd_dq, bias, causal)
    return [dq] if bias is None else [dq, dbias]


def _bwd_dkdv_cuda(q, k, v, do, lse, delta, k_len, bias, sm_scale,
                   dropout_rate, dropout_seed, causal, heads=(0, 0)):
    """[dk, dv] of the simple dk/dv kernel."""
    _check_bwd_inputs(q, k, v, do, lse, delta, k_len)
    if bias is not None:
        check_bias(q, k, bias)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_attention_bwd_dkdv", q, k, v, bias, do, lse, delta,
                k_len, (dk, dv), sm_scale, dropout_rate, dropout_seed, causal,
                heads)
    _count_bwd(flash_attention_bwd_dkdv, bias, causal)
    return [dk, dv]


def _bwd_sm90_cuda(q, k, v, do, lse, delta, k_len, bias, sm_scale,
                   dropout_rate, dropout_seed, causal, heads=(0, 0)):
    """[dq, dk, dv] (with ``bias`` and dbias) of the Hopper design's fused
    backward; raises for inputs that design does not take."""
    _check_bwd_inputs(q, k, v, do, lse, delta, k_len)
    if bias is not None:
        check_bias(q, k, bias)
        if causal:
            raise ValueError("the bias (K6) is non-causal")
    if _design(q, k, v, bias, (do,)) != "sm90":
        raise ValueError("flash_attention_bwd_sm90 takes bf16, d in "
                         f"{SM90_HEAD_DIMS}, 16-byte aligned inputs and a "
                         "bias only where T_k % 8 == 0")
    flag, threshold, scale, seed = _dropout_args(dropout_rate, dropout_seed)
    b, h, t_q, d = q.shape
    heads = _head_args(h, *heads)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dbias = None if bias is None else torch.empty_like(bias)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _sm90_bwd()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            k_len.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(dbias), b, h, t_q, k.shape[2], d,
            float(sm_scale), flag, threshold, scale, seed, int(causal),
            *heads, stream)
    _raise_on(err, SM90_BWD_KERNEL)
    _count_bwd(flash_attention_bwd_sm90, bias, causal)
    grads = [dq_acc.to(q.dtype), dk, dv]
    return grads if bias is None else [*grads, dbias]


_BWD_KERNELS = {"dq": _bwd_dq_cuda, "dkdv": _bwd_dkdv_cuda,
                "sm90": _bwd_sm90_cuda}


def _bwd_cuda(q, k, v, do, lse, delta, k_len, bias, sm_scale, dropout_rate,
              dropout_seed, causal, kernel, head_offset=0, heads_total=0):
    """The backward kernels from delta: with ``kernel="auto"`` those of
    ``select_design``'s choice, with "simple" the simple pair ([dq, dk, dv]
    and with ``bias`` dbias, in both cases); "dq", "dkdv" or "sm90" the one
    kernel of that name."""
    args = (q, k, v, do, lse, delta, k_len, bias, sm_scale, dropout_rate,
            dropout_seed, causal, (head_offset, heads_total))
    if kernel == "auto":
        kernel = ("sm90" if _design(q, k, v, bias, (do,)) == "sm90"
                  else "simple")
    if kernel != "simple":
        return _BWD_KERNELS[kernel](*args)
    dq = _bwd_dq_cuda(*args)
    dk, dv = _bwd_dkdv_cuda(*args)
    return [dq[0], dk, dv, *dq[1:]]


# ---- the custom ops ---------------------------------------------------------
#
# Every kernel of this file is reached through one of two ops of the
# ``tts_port`` namespace, so that autograd, torch.export and opcheck see
# one operator each: a fake implementation (shapes and dtypes only), a CPU
# implementation (the plain version) and a CUDA one (the launch; no path to
# the plain version). Design choice and alignment checks read data
# pointers, so they sit inside the CUDA implementations.

def _plain(tensors):
    return [t.contiguous() for t in tensors]


def _fwd_cpu(q, k, v, k_len, bias, sm_scale, dropout_rate, dropout_seed,
             causal, design, head_offset=0, heads_total=0):
    return tuple(_plain(flash_attention_fwd_reference(
        q, k, v, k_len, sm_scale, dropout_rate, dropout_seed, causal, bias,
        *_head_args(q.shape[1], head_offset, heads_total))))


_flash_fwd_op = torch.library.custom_op(
    "tts_port::flash_fwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor k_len, Tensor? bias, "
           "float sm_scale, float dropout_rate, int dropout_seed, "
           "bool causal, str design, int head_offset=0, "
           "int heads_total=0) -> (Tensor, Tensor)")(_fwd_cpu)
_flash_fwd_op.register_kernel("cuda")(_forward_cuda)


@_flash_fwd_op.register_fake
def _(q, k, v, k_len, bias, sm_scale, dropout_rate, dropout_seed, causal,
      design, head_offset=0, heads_total=0):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _fwd_setup(ctx, inputs, output):
    (q, k, v, k_len, bias, sm_scale, dropout_rate, dropout_seed, causal, _,
     head_offset, heads_total) = inputs
    o, lse = output
    ctx.save_for_backward(q, k, v, bias, o, lse, k_len)
    ctx.args = (sm_scale, dropout_rate, dropout_seed, causal, head_offset,
                heads_total)
    ctx.mark_non_differentiable(lse)


def _fwd_backward(ctx, do, _dlse):
    """Gradients for q, k, v (and the bias) from the backward op,
    recomputing P and the keep mask; none for k_len, the scale, the rate,
    the seed, the causal flag or the heads, and none through lse."""
    q, k, v, bias, o, lse, k_len = ctx.saved_tensors
    (sm_scale, dropout_rate, dropout_seed, causal, head_offset,
     heads_total) = ctx.args
    grads = flash_attention_bwd(
        q, k, v, o, lse, do.to(q.dtype).contiguous(), k_len,
        sm_scale=sm_scale, dropout_rate=dropout_rate,
        dropout_seed=dropout_seed, causal=causal, bias=bias,
        head_offset=head_offset, heads_total=heads_total)
    dbias = grads[3] if bias is not None else None
    return (*grads[:3], None, dbias, None, None, None, None, None, None,
            None)


_flash_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _bwd_cpu(q, k, v, do, lse, delta, k_len, bias, sm_scale, dropout_rate,
             dropout_seed, causal, kernel, head_offset=0, heads_total=0):
    args = (q, k, v, do, lse, delta, k_len, sm_scale, dropout_rate,
            dropout_seed, causal, bias,
            *_head_args(q.shape[1], head_offset, heads_total))
    dq = dkdv = ()
    if kernel != "dkdv":
        dq = flash_attention_dq_reference(*args)
        dq = (dq,) if bias is None else dq
    if kernel != "dq":
        dkdv = flash_attention_dkdv_reference(*args)
    return _plain((*dq[:1], *dkdv, *dq[1:]))


_flash_bwd_op = torch.library.custom_op(
    "tts_port::flash_bwd", mutates_args=(), device_types="cpu",
    schema="(Tensor q, Tensor k, Tensor v, Tensor do, Tensor lse, "
           "Tensor delta, Tensor k_len, Tensor? bias, float sm_scale, "
           "float dropout_rate, int dropout_seed, bool causal, "
           "str kernel, int head_offset=0, int heads_total=0) -> Tensor[]"
           )(_bwd_cpu)
_flash_bwd_op.register_kernel("cuda")(_bwd_cuda)


@_flash_bwd_op.register_fake
def _(q, k, v, do, lse, delta, k_len, bias, sm_scale, dropout_rate,
      dropout_seed, causal, kernel, head_offset=0, heads_total=0):
    grads = [torch.empty_like(x) for x in (q, k, v)]
    dbias = [] if bias is None else [torch.empty_like(bias)]
    if kernel == "dq":
        return grads[:1] + dbias
    if kernel == "dkdv":
        return grads[1:]
    return grads + dbias


# ---- the public wrappers ----------------------------------------------------

def _forward(q, k, v, k_len, sm_scale, dropout_rate, dropout_seed, causal,
             bias=None, design=None, head_offset=0, heads_total=None):
    """(o, lse) through ``tts_port::flash_fwd``: K1 (rate 0) or K1-d, with
    ``causal`` K3-f or K3-d, with ``bias`` K6 or K6-d, on the card; the
    plain version on the CPU. ``design="simple"`` forces the simple kernel
    in the Hopper design's mode (the same-run A/B's baseline);
    ``head_offset`` and ``heads_total`` set the dropout hash's batch-heads
    (``hash_heads``)."""
    return _flash_fwd_op(q, k, v, k_len, bias, float(sm_scale),
                         float(dropout_rate), int(dropout_seed),
                         bool(causal), design or "auto", int(head_offset),
                         int(heads_total or 0))


def _bwd_kernel(kernel, q, k, v, do, lse, delta, k_len, sm_scale,
                dropout_rate, dropout_seed, causal, bias, head_offset=0,
                heads_total=None):
    """The gradients of ``tts_port::flash_bwd`` with ``kernel``."""
    return _flash_bwd_op(q, k, v, do, lse, delta, k_len, bias,
                         float(sm_scale), float(dropout_rate),
                         int(dropout_seed), bool(causal), kernel,
                         int(head_offset), int(heads_total or 0))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, k_len, *, sm_scale,
                           dropout_rate=0.0, dropout_seed=0, causal=False,
                           bias=None, head_offset=0, heads_total=None):
    """dq from the forward's lse and ``delta``: K2's dq kernel (K3's with
    ``causal``) on the card, its plain version on the CPU. With ``bias``
    K6's: (dq, dbias), dbias like the bias, written whole by the kernel
    (zeros past ``k_len`` included), so it is allocated uninitialised."""
    out = _bwd_kernel("dq", q, k, v, do, lse, delta, k_len, sm_scale,
                      dropout_rate, dropout_seed, causal, bias, head_offset,
                      heads_total)
    return out[0] if bias is None else tuple(out)


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, k_len, *, sm_scale,
                             dropout_rate=0.0, dropout_seed=0, causal=False,
                             bias=None, head_offset=0, heads_total=None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the forward's lse and ``delta``: K2's dk/dv kernel
    (K3's with ``causal``, K6's with ``bias``) on the card, its plain
    version on the CPU."""
    return tuple(_bwd_kernel("dkdv", q, k, v, do, lse, delta, k_len,
                             sm_scale, dropout_rate, dropout_seed, causal,
                             bias, head_offset, heads_total))


for _wrapper in (flash_attention_bwd_dq, flash_attention_bwd_dkdv):
    _wrapper.launches = 0           # K2
    _wrapper.causal_launches = 0    # K3
    _wrapper.bias_launches = 0      # K6


def flash_attention_bwd_sm90(q, k, v, do, lse, delta, k_len, *, sm_scale,
                             dropout_rate=0.0, dropout_seed=0, causal=False,
                             bias=None, head_offset=0, heads_total=None
                             ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) from the forward's lse and ``delta``: the Hopper
    design's fused K2 (with ``causal`` K3's backward; csrc/flash_bwd_sm90.cu,
    bf16) on the card, the plain dq and dk/dv on the CPU. With ``bias``
    K6's: (dq, dk, dv, dbias), dbias like the bias and written whole by
    the kernel (zeros past ``k_len`` included), so it is allocated
    uninitialised. dq is summed in an fp32 accumulator zeroed in the op,
    with atomics in the kernel, then cast to q's dtype: unlike dk, dv and
    dbias it varies from run to run in its last bits."""
    return tuple(_bwd_kernel("sm90", q, k, v, do, lse, delta, k_len,
                             sm_scale, dropout_rate, dropout_seed, causal,
                             bias, head_offset, heads_total))


flash_attention_bwd_sm90.launches = 0           # K2, the Hopper design
flash_attention_bwd_sm90.causal_launches = 0    # K3's, the Hopper design
flash_attention_bwd_sm90.bias_launches = 0      # K6's, the Hopper design


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, k_len: torch.Tensor, *,
    sm_scale: float, dropout_rate: float = 0.0, dropout_seed: int = 0,
    causal: bool = False, bias: Optional[torch.Tensor] = None,
    head_offset: int = 0, heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``flash_attention`` for the output gradient ``do``:
    delta, then ``tts_port::flash_bwd`` -- on the card the kernels of
    ``select_design``'s choice, the Hopper design's fused K2, K3 or K6 or
    the simple pair, K2's (with ``causal`` K3's, with ``bias`` K6's) dq
    and dk/dv kernels; the plain version on the CPU. With ``bias``, K6's:
    (dq, dk, dv, dbias)."""
    if o.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o must match q: {tuple(o.shape)} {o.dtype}")
    return tuple(_bwd_kernel("auto", q, k, v, do, lse, bwd_delta(o, do),
                             k_len, sm_scale, dropout_rate, dropout_seed,
                             causal, bias, head_offset, heads_total))


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_len: torch.Tensor,
    *, sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
    dropout_seed: int = 0, causal: bool = False, head_offset: int = 0,
    heads_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of masked attention; q (B,H,T_q,d), k/v (B,H,T_k,d).

    ``k_len`` (B,) int32 is the number of valid keys per batch row;
    ``causal`` also masks keys past the query row (K3);
    ``sm_scale`` defaults to 1/sqrt(d). ``dropout_rate`` > 0 drops
    attention probabilities with the hash seeded by ``dropout_seed`` (an
    int32; the backward rebuilds the same mask). A tensor that holds heads
    [``head_offset``, ``head_offset`` + H) of a model's ``heads_total``
    (tensor parallelism; default the tensor's own H) draws the unsharded
    mask's slice (``hash_heads``). ``o`` has q's dtype and carries
    gradients to q, k and v (the backward op); ``lse`` (B, H, T_q) is fp32
    and carries none.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, k_len, sm_scale, dropout_rate, dropout_seed,
                    causal, head_offset=head_offset, heads_total=heads_total)


flash_attention.launches = 0                    # K1
flash_attention.dropout_launches = 0            # K1-d
flash_attention.sm90_launches = 0               # K1, the Hopper design
flash_attention.sm90_dropout_launches = 0       # K1-d, the Hopper design
flash_attention.causal_launches = 0             # K3-f
flash_attention.causal_dropout_launches = 0     # K3-d
flash_attention.sm90_causal_launches = 0        # K3-f, the Hopper design
flash_attention.sm90_causal_dropout_launches = 0  # K3-d, the Hopper design


def flash_attention_with_bias(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
    k_len: torch.Tensor, *, sm_scale: Optional[float] = None,
    dropout_rate: float = 0.0, dropout_seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of softmax((q k^T + bias) * sm_scale, keys c < k_len[b]) v,
    differentiable in q, k, v and ``bias`` (the port of
    ``flash_attention_with_bias``; non-causal), as ``_flash_b``'s VJP:
    dbias in the bias's dtype.

    ``bias`` (B, H, T_q, T_k), contiguous, in q's dtype, is added in fp32
    before the scale (the relative-position term of the conformer's
    attention built in device memory, ``rel_shift(q_v P^T)``); its gradient
    is the pre-scale logit gradient. ``sm_scale`` defaults to 1/sqrt(d);
    ``dropout_rate`` and ``dropout_seed`` as in ``flash_attention``.
    """
    check_bias(q, k, bias)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, k_len, sm_scale, dropout_rate, dropout_seed,
                    False, bias)


flash_attention_with_bias.launches = 0          # K6
flash_attention_with_bias.dropout_launches = 0  # K6-d
flash_attention_with_bias.sm90_launches = 0     # K6, the Hopper design
flash_attention_with_bias.sm90_dropout_launches = 0  # K6-d, the Hopper design


def _fwd_kernel():
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = cuda_build.load(KERNEL).flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernels():
    from transformer_tts_tpu_torch.ops import cuda_build
    lib = cuda_build.load(BWD_KERNEL)
    tail = ([ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
               ctypes.c_uint32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p])
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
        fn = getattr(lib, name)
        if fn.argtypes is None:   # 8 inputs (bias nullable), 2 outputs
            fn.argtypes = [ctypes.c_void_p] * 10 + tail
            fn.restype = ctypes.c_int
    return lib


def _sm90_entry(name: str, pointers: int):
    """The Hopper design's entry point ``name`` (its library built on first
    use): ``pointers`` device pointers, then B, H, T_q, T_k and d, then the
    scale, the dropout flag, threshold, keep scale and seed, the causal
    flag, the hash's head offset and heads total, and the stream."""
    from transformer_tts_tpu_torch.ops import cuda_build
    fn = getattr(cuda_build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_uint32,
                          ctypes.c_float, ctypes.c_uint32, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _sm90_fwd():    # q, k, v, bias (nullable), k_len, o, lse
    return _sm90_entry(SM90_KERNEL, 7)


def _sm90_bwd():    # q, k, v, bias, do, lse, delta, k_len, dq_acc, dk, dv,
    return _sm90_entry(SM90_BWD_KERNEL, 12)     # dbias (bias, dbias nullable)
