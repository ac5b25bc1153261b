"""Prenets (the port of ``DecoderPreNet`` and ``EncoderPreNet``,
transformer_tts_tpu/models/prenets.py:19-58).

``DecoderPreNet``: two layers, mel -> 256 -> d_model, each followed by
ReLU and dropout (0.5 in the flagship), under the reference torch repo's
names ``layer.fc1`` and ``layer.fc2``. The dropout is a plain
``nn.Dropout``: on in train mode, off in eval mode, so synthesis runs the
prenet without it, as the JAX package's ``train=False`` does. In the
discrete-token mode (``output_type``) fc1 is an embedding over
``input_size`` codes, so (B, T, S) int codes give (B, T, S, d_model),
one row per stream (models/decoder.py sums them).

``EncoderPreNet``: the JAX package's working version of the reference's
text prenet (whose ``final_out`` is undefined, so it never ran): an
embedding, three 1-wide convs each with BatchNorm, ReLU and dropout,
and a Linear ``final_out``. No model builds it.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_tts_tpu_torch.ops.feedforward import Conv1dBTC, batch_norm


class DecoderPreNet(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 hidden_size: int = 256, dropout: float = 0.5,
                 output_type: bool = False):
        super().__init__()
        fc1 = (nn.Embedding(input_size, hidden_size) if output_type
               else nn.Linear(input_size, hidden_size))
        self.layer = nn.ModuleDict({
            "fc1": fc1, "fc2": nn.Linear(hidden_size, output_size)})
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, mel) frames, or (B, T, S) int codes in the discrete mode
        -> (B, T, output_size) or (B, T, S, output_size)."""
        h = self.dropout(torch.relu(self.layer["fc1"](x)))
        return self.dropout(torch.relu(self.layer["fc2"](h)))


class EncoderPreNet(nn.Module):
    N_CONVS = 3

    def __init__(self, vocab_size: int, d_model: int, dropout: float = 0.1):
        super().__init__()
        self.embed = nn.Embedding(vocab_size, d_model)
        self.convs = nn.ModuleList(Conv1dBTC(d_model, d_model, 1)
                                   for _ in range(self.N_CONVS))
        self.batch_norms = nn.ModuleList(batch_norm(d_model)
                                         for _ in range(self.N_CONVS))
        self.final_out = nn.Linear(d_model, d_model)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> (B, L, d_model)."""
        h = self.embed(x)
        for conv, bn in zip(self.convs, self.batch_norms):
            h = bn(conv(h).transpose(1, 2)).transpose(1, 2)
            h = self.dropout(torch.relu(h))
        return self.final_out(h)
