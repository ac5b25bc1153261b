"""Pre-norm transformer encoder block (the port of ``EncoderLayer``,
transformer_tts_tpu/models/layers.py:53-85).

norm -> self-attention -> +residual; norm -> conv FFN -> +residual.
Speaker conditioning (``SpeakerBias``) is multi-speaker and comes with a
later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.ops.attention import MultiHeadAttention
from transformer_tts_tpu_torch.ops.feedforward import ConvFeedForward, LN_EPS


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ff_kernel_size: int,
                 dropout: float = 0.1, concat_after: bool = False,
                 use_flash: bool = False):
        super().__init__()
        self.norm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = MultiHeadAttention(heads, d_model, dropout,
                                       concat_after=concat_after,
                                       use_flash=use_flash)
        self.ff = ConvFeedForward(d_model, ff_kernel_size, dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask, *, collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None):
        h = self.norm_1(x)
        out, attn = self.attn(h, h, h, mask, collect_attn=collect_attn,
                              k_len=k_len)
        x = x + self.dropout(out)
        x = x + self.dropout(self.ff(self.norm_2(x)))
        return x, attn
