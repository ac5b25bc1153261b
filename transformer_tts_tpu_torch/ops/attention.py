"""Multi-head attention (the port of transformer_tts_tpu/ops/attention.py:
``scaled_dot_attention`` and ``MultiHeadAttention``, without KV cache,
precomputed K/V, causal masks or relative positions, which come with the
AR and conformer slices).

* logits = QK^T / sqrt(d_k) in fp32 (bf16 inputs under amp), masked
  logits filled with -1e4, softmax in fp32, probabilities cast to the value
  dtype before P.V;
* separate q/k/v projections and the optional ``concat_after``;
* attention over at least ``FLASH_MIN_KEY_LEN`` keys with a prefix key
  mask given as ``k_len`` goes to the flash-attention kernel
  (ops/flash_attention.py), when no attention maps are asked for.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from transformer_tts_tpu_torch.ops.flash_attention import flash_attention

NEG_FILL = -1e4

# Least key length sent to the kernel. The JAX package chose 256 on a TPU;
# the port keeps it for parity until a measurement on the card sets it
# (chip_smoke.py times both paths at T in {128, 256, 768, 2048}).
FLASH_MIN_KEY_LEN = 256


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


class MultiHeadAttention(nn.Module):
    """Reference-compatible MHA with the flash-kernel dispatch rule."""

    def __init__(self, heads: int, d_model: int, dropout: float = 0.1,
                 concat_after: bool = False, use_flash: bool = False):
        super().__init__()
        self.heads = heads
        self.d_model = d_model
        self.concat_after = concat_after
        self.use_flash = use_flash
        self.q_linear = nn.Linear(d_model, d_model)
        self.k_linear = nn.Linear(d_model, d_model)
        self.v_linear = nn.Linear(d_model, d_model)
        self.out = nn.Linear(2 * d_model if concat_after else d_model,
                             d_model)
        self.dropout = nn.Dropout(dropout)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        return x.reshape(b, -1, self.heads,
                         self.d_model // self.heads).transpose(1, 2)

    def forward(self, q_in, k_in, v_in, mask=None, *,
                collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None):
        """Returns (output (B, T_q, d_model), probs or None)."""
        b = q_in.shape[0]
        q = self._heads(self.q_linear(q_in))
        k = self._heads(self.k_linear(k_in))
        v = self._heads(self.v_linear(v_in))

        flash_ok = (self.use_flash and not collect_attn
                    and k_len is not None
                    and k.shape[2] >= FLASH_MIN_KEY_LEN)
        if flash_ok and mask is not None and mask.shape[1] != 1:
            raise ValueError(
                "k_len stands for a prefix key mask; a structured (B, T, T) "
                "mask needs k_len=None")
        if flash_ok:
            if self.training and self.dropout.p > 0.0:
                raise NotImplementedError(
                    "attention-prob dropout inside the kernel (K1-d) comes "
                    "with the training slice of the port")
            context, _ = flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(),
                                         k_len.to(torch.int32).contiguous())
            probs = None
        else:
            context, probs = scaled_dot_attention(q, k, v, mask,
                                                  dropout=self.dropout)

        concat = context.transpose(1, 2).reshape(b, -1, self.d_model)
        if self.concat_after:
            concat = torch.cat([q_in.to(concat.dtype), concat], dim=-1)
        return self.out(concat), (probs if collect_attn else None)
