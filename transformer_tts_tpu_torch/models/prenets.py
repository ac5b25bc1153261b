"""The AR decoder's prenet (the port of ``DecoderPreNet``,
transformer_tts_tpu/models/prenets.py:19-37).

Two Linear layers, mel -> 256 -> d_model, each followed by ReLU and
dropout (0.5 in the flagship), under the reference torch repo's names
``layer.fc1`` and ``layer.fc2``. The dropout is a plain ``nn.Dropout``:
on in train mode, off in eval mode, so synthesis runs the prenet without
it, as the JAX package's ``train=False`` does. The discrete-token mode
(``output_type``, an Embedding fc1) raises with the other model families;
the JAX package's working ``EncoderPreNet``, which no model builds, is
left to the slice "other model families".
"""

from __future__ import annotations

import torch
from torch import nn


class DecoderPreNet(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 hidden_size: int = 256, dropout: float = 0.5):
        super().__init__()
        self.layer = nn.ModuleDict({
            "fc1": nn.Linear(input_size, hidden_size),
            "fc2": nn.Linear(hidden_size, output_size)})
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, mel) -> (B, T, output_size)."""
        h = self.dropout(torch.relu(self.layer["fc1"](x)))
        return self.dropout(torch.relu(self.layer["fc2"](h)))
