"""Absolute sinusoidal positional encoding (the port of
transformer_tts_tpu/ops/positional.py:28-76).

``sinusoid_table`` keeps the reference's doubled exponent: column j gets
angle ``pos / 10000**(2j/d)``, sin for even j and cos for odd j, computed
in fp32. ``PositionalEncoder`` adds it scaled by a learnable ``alpha``.
"""

from __future__ import annotations

import torch
from torch import nn

MAX_ABS_POSITIONS = 5000


def sinusoid_table(max_len: int, d_model: int,
                   device=None) -> torch.Tensor:
    """(max_len, d_model) fp32 table with the reference's doubled exponent."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(d_model, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2.0 * j / d_model)
    return torch.where(j % 2 == 0, torch.sin(angle), torch.cos(angle))


class PositionalEncoder(nn.Module):
    """x + alpha * PE[:T], then dropout."""

    def __init__(self, d_model: int, dropout: float = 0.1,
                 max_len: int = MAX_ABS_POSITIONS):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.dropout = nn.Dropout(dropout)
        # derived from the sizes, so not part of the state_dict
        self.register_buffer("table", sinusoid_table(max_len, d_model),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pe = self.table[: x.shape[1]]
        return self.dropout(x + self.alpha * pe[None])
