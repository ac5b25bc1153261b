"""Convolutions on (B, T, C) and the conv feed-forward block (the port of
transformer_tts_tpu/ops/feedforward.py:27-44).

``ConvFeedForward`` keeps the reference's ordering: Conv1d(d -> 4d), ReLU,
Conv1d(4d -> d), the residual added inside the module, then dropout, then
LayerNorm. ``EncoderLayer`` adds a second residual around it.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


class Conv1dBTC(nn.Conv1d):
    """``nn.Conv1d`` on (B, T, C) tensors with flax's padding: "SAME"
    ((k-1)//2 left, k//2 right) or an explicit (left, right) pair."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int,
                 padding: Union[str, Tuple[int, int]] = "SAME"):
        if padding == "SAME":
            padding = ((kernel_size - 1) // 2, kernel_size // 2)
        left, right = padding
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=left if left == right else 0)
        self.pad = None if left == right else (left, right)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return super().forward(x).transpose(1, 2)


class ConvFeedForward(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.f_1 = Conv1dBTC(d_model, d_model * 4, kernel_size)
        self.f_2 = Conv1dBTC(d_model * 4, d_model, kernel_size)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.f_2(torch.relu(self.f_1(x)))
        return self.layer_norm(self.dropout(h + x))
