"""Causal conv postnet (the port of ``PostConvNet``,
transformer_tts_tpu/models/postnets.py:36-75).

``prev_version=True`` (FastSpeech 2): Linear(d -> mel*r) gives the "pre"
mel; then 5 causal Conv1d(k=5), each left-padded by 4, with BatchNorm +
tanh + dropout between them, and a residual add gives the "post" mel; it
returns both. ``prev_version=False`` (the AR Transformer-TTS): no Linear,
the input is the pre mel (B, T, mel*r) and it returns the post mel only;
``identity_compat`` returns the input instead, the reference's no-op
postnet (its statistics still move in train mode, as in the JAX
package, which runs the stack and drops its output). BatchNorm follows
flax: eps 1e-5,
momentum 0.99 (torch ``momentum=0.01``); in eval mode it uses the running
statistics. The mel-to-mel models and the VQ codebook come with a later
slice.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_tts_tpu_torch.ops.feedforward import Conv1dBTC, batch_norm

CAUSAL = (4, 0)


class PostConvNet(nn.Module):
    def __init__(self, num_hidden: int, mel_dim: int,
                 reduction_rate: int = 1, dropout: float = 0.5,
                 prev_version: bool = True, identity_compat: bool = False):
        super().__init__()
        out_dim = mel_dim * reduction_rate
        self.prev_version = prev_version
        self.identity_compat = identity_compat
        if prev_version:
            self.out = nn.Linear(num_hidden, out_dim)
        self.conv1 = Conv1dBTC(out_dim, num_hidden, 5, CAUSAL)
        self.pre_batchnorm = batch_norm(num_hidden)
        self.conv_list = nn.ModuleList(
            Conv1dBTC(num_hidden, num_hidden, 5, CAUSAL) for _ in range(3))
        self.batch_norm_list = nn.ModuleList(
            batch_norm(num_hidden) for _ in range(3))
        self.conv2 = Conv1dBTC(num_hidden, out_dim, 5, CAUSAL)
        self.dropout = nn.Dropout(dropout)

    def _norm_act(self, bn: nn.BatchNorm1d, h: torch.Tensor) -> torch.Tensor:
        h = bn(h.transpose(1, 2)).transpose(1, 2)
        return self.dropout(torch.tanh(h))

    def forward(self, x: torch.Tensor):
        """``prev_version``: (B, T, num_hidden) -> (mel_pre, mel_post), each
        (B, T, mel*r); else (B, T, mel*r) -> mel_post (B, T, mel*r)."""
        mel_pred = self.out(x) if self.prev_version else x
        h = self._norm_act(self.pre_batchnorm, self.conv1(mel_pred))
        for conv, bn in zip(self.conv_list, self.batch_norm_list):
            h = self._norm_act(bn, conv(h))
        post = mel_pred + self.conv2(h)
        if self.prev_version:
            return mel_pred, post
        return mel_pred if self.identity_compat else post
