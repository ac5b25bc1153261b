"""Multi-head attention (the port of transformer_tts_tpu/ops/attention.py:
``scaled_dot_attention``, ``MultiHeadAttention`` with its KV cache,
precomputed K/V and causal dispatch, and the conformer's
``RelativeMultiHeadAttention``).

* logits = QK^T / sqrt(d_k) in fp32 (bf16 inputs under amp), masked
  logits filled with -1e4, softmax in fp32, probabilities cast to the value
  dtype before P.V;
* separate q/k/v projections and the optional ``concat_after``;
* attention over at least ``FLASH_MIN_KEY_LEN`` keys with a prefix key
  mask given as ``k_len`` goes to the flash-attention kernels
  (ops/flash_attention.py), when no attention maps are asked for and no
  KV cache is in play; in train mode their attention-prob dropout runs
  inside the kernel, with a fresh int32 seed per call drawn from the
  caller's ``generator``. ``causal=True`` (the AR decoder's masked
  self-attention, whose (B, T, T) pad-and-causal mask ``k_len`` then
  stands for) takes the causal kernels, K3;
* the AR decode step's KV cache: static (B, H, max_steps, d_k) tensors
  into which the step's k/v row is written in place at ``cache_index``;
  the caller masks the rows past it. The cache always takes the masked
  path, as in the JAX package;
* relative-position self-attention under the same rule goes to K4, or
  in train mode with dropout to K4-d, and back through K5
  (ops/flash_relpos.py), its seed drawn as for ``MultiHeadAttention``; its
  masked path fills with -2^15 after scaling;
* under tensor parallelism (parallel/tp.py sets ``tp``) a module holds a
  slice of the heads: it reads their number from the width of its
  projections, passes the kernels its first head and the model's head
  count (the dropout hash's batch-heads), takes its projections as
  column-split products (``tp.column``) and ``out`` as a row-split one
  (``tp.row``, its partial products summed over the group), and its
  masked path keeps its heads' slice of the whole dropout mask; maps
  asked for are gathered over the group, every head's on each rank.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
from transformer_tts_tpu_torch.ops.flash_relpos import (
    flash_relpos_attention, rel_shift)

NEG_FILL = -1e4
NEG_FILL_REL = -(2.0 ** 15)

# Least key length sent to the kernel. The JAX package chose 256 on a TPU;
# the port keeps it for parity until a measurement on the card sets it
# (chip_smoke.py times both paths at T in {128, 256, 768, 2048}).
FLASH_MIN_KEY_LEN = 256


def _kernel_dropout(module: nn.Module, generator: Optional[torch.Generator]
                    ) -> Tuple[float, int]:
    """(rate, seed) of the kernel path's in-kernel dropout: the module's
    rate and a fresh int32 seed from ``generator`` in train mode, else
    (0.0, 0)."""
    if not (module.training and module.dropout.p > 0.0):
        return 0.0, 0
    return module.dropout.p, int(torch.randint(-2 ** 31, 2 ** 31, (),
                                               generator=generator))


def scaled_dot_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    mask: Optional[torch.Tensor], *, dropout: Optional[nn.Module] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(QK^T/sqrt(d_k))V on (B, H, T, d_k) tensors.

    ``mask``: (B, 1 or T_q, T_k) bool, True = attend. Returns
    (context (B, H, T_q, d_k) in v's dtype, probs (B, H, T_q, T_k) fp32).
    """
    with torch.autocast(q.device.type, enabled=False):
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], NEG_FILL)
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    context = torch.matmul(probs.to(v.dtype), v)
    return context, probs


def relative_dot_attention(
    q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    p: torch.Tensor, mask: Optional[torch.Tensor], *,
    dropout: Optional[nn.Module] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax((q_u K^T + rel_shift(q_v P^T))/sqrt(d_k))V, the masked path
    of ``RelativeMultiHeadAttention``; p (1 or B, H, T, d_k), masked
    logits filled with -2^15. Returns (context, probs (B, H, T_q, T_k))."""
    with torch.autocast(q_u.device.type, enabled=False):
        ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
        bd = torch.matmul(q_v.float(), p.float().transpose(-1, -2))
    scores = (ac + rel_shift(bd)) / math.sqrt(q_u.shape[-1])
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None], NEG_FILL_REL)
    probs = torch.softmax(scores, dim=-1)
    if dropout is not None:
        probs = dropout(probs)
    context = torch.matmul(probs.to(v.dtype), v)
    return context, probs


class MultiHeadAttention(nn.Module):
    """Reference-compatible MHA with the flash-kernel dispatch rule.
    ``q_dim`` is the query input's width when it is not ``d_model`` (the
    GST style tokens' 128-d query; flax infers it)."""

    def __init__(self, heads: int, d_model: int, dropout: float = 0.1,
                 concat_after: bool = False, use_flash: bool = False,
                 q_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.d_model = d_model
        self.concat_after = concat_after
        self.use_flash = use_flash
        self.q_linear = nn.Linear(q_dim or d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.out = nn.Linear(2 * d_model if concat_after else d_model,
                             d_model)
        self.dropout = nn.Dropout(dropout)
        self.tp = None          # parallel/tp.py, once the heads are split

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H_local * d_k) -> (B, H_local, T, d_k)."""
        return _split_heads(x, self.d_model // self.heads).transpose(1, 2)

    @property
    def local_heads(self) -> int:
        """The heads this module computes: all of them, or a
        tensor-parallel rank's."""
        return self.k_linear.weight.shape[0] // (self.d_model // self.heads)

    def project_kv(self, k_in: torch.Tensor, v_in: torch.Tensor):
        """(k, v) head tensors (B, H, T, d_k): the cross-attention K/V that
        the AR decode loop computes once."""
        k, v = _project(self, (self.k_linear, k_in), (self.v_linear, v_in))
        return self._heads(k), self._heads(v)

    def forward(self, q_in, k_in, v_in, mask=None, *,
                collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                causal: bool = False,
                cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                cache_index=None,
                precomputed_kv: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None):
        """Returns (output (B, T_q, d_model), probs or None).

        ``generator`` (a CPU generator, so drawing never waits for the
        card) seeds the kernel path's dropout; None draws from torch's
        default CPU generator. ``cache`` = (k_cache, v_cache), each
        (B, H, max_steps, d_k): the new k/v rows are written into them in
        place at ``cache_index`` (an int or a (1,) integer tensor on their
        device), so the caller's tensors hold the update, and attention
        runs over the whole static cache, ``mask`` hiding the rows past the
        index. ``precomputed_kv`` replaces the k/v projections.
        """
        tp = self.tp
        if precomputed_kv is not None:
            q, = _project(self, (self.q_linear, q_in))
            k, v = precomputed_kv
        else:
            q, k, v = _project(self, (self.q_linear, q_in),
                               (self.k_linear, k_in), (self.v_linear, v_in))
            k, v = self._heads(k), self._heads(v)
        q = self._heads(q)
        if cache is not None:
            if cache_index is None:
                raise ValueError("a cache needs cache_index")
            k_cache, v_cache = cache
            index = torch.as_tensor(cache_index, device=k_cache.device)
            index = index.reshape(-1) + torch.arange(k.shape[2],
                                                     device=k_cache.device)
            k_cache.index_copy_(2, index, k.to(k_cache.dtype))
            v_cache.index_copy_(2, index, v.to(v_cache.dtype))
            k, v = k_cache, v_cache

        flash_ok = (self.use_flash and not collect_attn and cache is None
                    and k_len is not None
                    and k.shape[2] >= FLASH_MIN_KEY_LEN)
        if flash_ok and mask is not None and mask.shape[1] != 1 \
                and not causal:
            raise ValueError(
                "k_len stands for a prefix key mask; a structured (B, T, T) "
                "mask needs causal=True (the pad-and-causal mask) or "
                "k_len=None")
        if flash_ok:
            rate, seed = _kernel_dropout(self, generator)
            context, _ = flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(),
                                         k_len.to(torch.int32).contiguous(),
                                         dropout_rate=rate,
                                         dropout_seed=seed, causal=causal,
                                         **_head_args(self, q))
            probs = None
        else:
            context, probs = scaled_dot_attention(
                q, k, v, mask, dropout=_masked_dropout(self))

        concat = _merge_heads(context)
        if tp is not None:
            return _row_out(self, concat, q_in), _maps(self, probs,
                                                       collect_attn)
        if self.concat_after:
            concat = torch.cat([q_in.to(concat.dtype), concat], dim=-1)
        return self.out(concat), (probs if collect_attn else None)


class RelativeMultiHeadAttention(nn.Module):
    """Transformer-XL relative MHA of the conformer, with the K4 dispatch
    rule: logits (q_u K^T + rel_shift(q_v P^T)) / sqrt(d_k), where
    q_u = q + pos_bias_u, q_v = q + pos_bias_v and P = linear_pos(pos_emb).
    """

    def __init__(self, heads: int, d_model: int, dropout: float = 0.1,
                 use_flash: bool = False):
        super().__init__()
        self.heads = heads
        self.d_model = d_model
        self.use_flash = use_flash
        d_k = d_model // heads
        self.q_linear = nn.Linear(d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.linear_pos = nn.Linear(d_model, d_model, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(heads, d_k))
        self.pos_bias_v = nn.Parameter(torch.zeros(heads, d_k))
        self.out = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)
        self.tp = None          # parallel/tp.py, once the heads are split

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H_local * d_k) -> (B, T, H_local, d_k)."""
        return _split_heads(x, self.d_model // self.heads)

    def forward(self, q_in, k_in, v_in, pos_emb, mask=None, *,
                collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``pos_emb`` (1 or B, T, d_model); ``generator`` seeds the kernel
        path's dropout, as in ``MultiHeadAttention``. Returns (output (B,
        T_q, d_model), probs or None)."""
        tp = self.tp
        q, k, v, p = (self._split(t) for t in _project(
            self, (self.q_linear, q_in), (self.k_linear, k_in),
            (self.v_linear, v_in), (self.linear_pos, pos_emb)))
        k, v, p = k.transpose(1, 2), v.transpose(1, 2), p.transpose(1, 2)
        # the biases take q's dtype, so under autocast q_u and q_v stay
        # bf16 beside k and v, as in the JAX package
        q_u = (q + self.pos_bias_u.to(q.dtype)).transpose(1, 2)
        q_v = (q + self.pos_bias_v.to(q.dtype)).transpose(1, 2)

        flash_ok = (self.use_flash and not collect_attn
                    and k_len is not None
                    and k.shape[2] >= FLASH_MIN_KEY_LEN
                    and q_u.shape == k.shape          # self-attention only
                    and p.shape[0] == 1)              # shared position table
        if k_len is not None and mask is not None and mask.shape[1] != 1:
            raise ValueError(
                "k_len stands for a prefix key mask; a structured (B, T, T) "
                "mask needs k_len=None")
        if flash_ok:
            rate, seed = _kernel_dropout(self, generator)
            context, _ = flash_relpos_attention(
                q_u.contiguous(), q_v.contiguous(), k.contiguous(),
                v.contiguous(), p[0].contiguous(),
                k_len.to(torch.int32).contiguous(), dropout_rate=rate,
                dropout_seed=seed, **_head_args(self, q_u))
            probs = None
        else:
            context, probs = relative_dot_attention(
                q_u, q_v, k, v, p, mask, dropout=_masked_dropout(self))

        concat = _merge_heads(context)
        if tp is not None:
            return _row_out(self, concat), _maps(self, probs, collect_attn)
        return self.out(concat), (probs if collect_attn else None)


def _split_heads(x: torch.Tensor, d_k: int) -> torch.Tensor:
    """(B, T, n * d_k) -> (B, T, n, d_k): as many heads as the width holds
    (all of them, or a tensor-parallel rank's)."""
    return x.reshape(x.shape[0], -1, x.shape[-1] // d_k, d_k)


def _merge_heads(context: torch.Tensor) -> torch.Tensor:
    """(B, n, T, d_k) -> (B, T, n * d_k)."""
    b, n, _, d_k = context.shape
    return context.transpose(1, 2).reshape(b, -1, n * d_k)


def _project(module: nn.Module, *pairs) -> list:
    """``linear(x)`` for each (linear, x) pair; under tensor parallelism
    the column-split products of the module's heads, their inputs'
    gradients summed over the group in one all-reduce."""
    if module.tp is None:
        return [linear(x) for linear, x in pairs]
    return module.tp.column(F.linear, [(x, linear.weight, linear.bias)
                                       for linear, x in pairs])


def _head_args(module: nn.Module, q: torch.Tensor) -> dict:
    """The kernels' dropout-hash heads: this rank's first head and the
    model's head count under tensor parallelism, else none."""
    if module.tp is None:
        return {}
    return module.tp.heads(q.shape[1], module.heads)


def _masked_dropout(module: nn.Module):
    """The masked path's dropout of the probabilities: the module's, or
    under tensor parallelism its heads' slice of the whole mask."""
    if module.tp is None:
        return module.dropout
    return lambda probs: module.tp.dropout(module.dropout, probs, 1)


def _maps(module: nn.Module, probs: Optional[torch.Tensor],
          collect_attn: bool) -> Optional[torch.Tensor]:
    """The attention maps asked for, every head's on each
    tensor-parallel rank."""
    if not collect_attn:
        return None
    return module.tp.gather(probs, 1)


def _row_out(module: nn.Module, concat: torch.Tensor,
             q_in: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out`` of a tensor-parallel rank's heads: its context columns'
    product summed over the group, then (``concat_after``) the ``q_in``
    columns' product and the bias, rounded once (``tp.row``)."""
    w = module.out.weight
    front = w.shape[1] - concat.shape[-1]
    return module.tp.row(F.linear, concat, w[:, front:], module.out.bias,
                         (q_in, w[:, :front]) if front else None)
