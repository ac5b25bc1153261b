"""Sinusoidal positional encodings (the port of
transformer_tts_tpu/ops/positional.py:28-93).

``sinusoid_table`` keeps the reference's doubled exponent: column j gets
angle ``pos / 10000**(2j/d)``, sin for even j and cos for odd j, computed
in fp32. ``PositionalEncoder`` adds it scaled by a learnable ``alpha``,
from row 0 or, in the AR decode loop, from the step's row.

``relative_sinusoid_table`` is the standard table of the conformer's
Transformer-XL attention: columns 2i and 2i+1 hold sin and cos of
``pos * 10000**(-2i/d)``. ``RelativePositionalEncoder`` returns the
input and that table's first T rows, each through dropout.
"""

from __future__ import annotations

import math

import torch
from torch import nn

MAX_ABS_POSITIONS = 5000
MAX_REL_POSITIONS = 3000


def sinusoid_table(max_len: int, d_model: int,
                   device=None) -> torch.Tensor:
    """(max_len, d_model) fp32 table with the reference's doubled exponent."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(d_model, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device),
                            2.0 * j / d_model)
    return torch.where(j % 2 == 0, torch.sin(angle), torch.cos(angle))


def relative_sinusoid_table(max_len: int, d_model: int,
                            device=None) -> torch.Tensor:
    """(max_len, d_model) fp32 standard table (sin even / cos odd)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    half = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    freq = torch.exp(half * -(math.log(10000.0) / d_model))
    angles = pos * freq[None, :]
    pe = torch.zeros(max_len, d_model, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


class PositionalEncoder(nn.Module):
    """x + alpha * PE[offset : offset + T], then dropout.

    ``offset`` (an int or a 0-d integer tensor on the table's device) is
    the AR decode step's position: the step's single row takes table row
    ``offset``. A tensor offset keeps the step free of host values.
    """

    def __init__(self, d_model: int, dropout: float = 0.1,
                 max_len: int = MAX_ABS_POSITIONS):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))
        self.dropout = nn.Dropout(dropout)
        # derived from the sizes, so not part of the state_dict
        self.register_buffer("table", sinusoid_table(max_len, d_model),
                             persistent=False)

    def forward(self, x: torch.Tensor, offset=0) -> torch.Tensor:
        t = x.shape[1]
        if isinstance(offset, torch.Tensor):
            pe = self.table.index_select(
                0, offset.reshape(1) + torch.arange(t, device=offset.device))
        else:
            pe = self.table[offset: offset + t]
        return self.dropout(x + self.alpha * pe[None])


class RelativePositionalEncoder(nn.Module):
    """(dropout(x * xscale), dropout(PE[None, :T])), xscale 1.

    Raises for T > ``max_len``, where the JAX package would silently
    return a table shorter than the input.
    """

    def __init__(self, d_model: int, dropout: float = 0.1,
                 xscale: float = 1.0, max_len: int = MAX_REL_POSITIONS):
        super().__init__()
        self.xscale = xscale
        self.dropout = nn.Dropout(dropout)
        self.register_buffer("table",
                             relative_sinusoid_table(max_len, d_model),
                             persistent=False)

    def forward(self, x: torch.Tensor):
        t = x.shape[1]
        if t > self.table.shape[0]:
            raise ValueError(f"sequence length {t} exceeds the relative "
                             f"position table ({self.table.shape[0]} rows)")
        return (self.dropout(x * self.xscale),
                self.dropout(self.table[None, :t]))
