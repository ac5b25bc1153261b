"""Encoder stacks (the port of ``Encoder`` and ``ConformerEncoder``,
transformer_tts_tpu/models/encoder.py:49-174), used for the text encoder
and for FastSpeech 2's "decoder" over mel frames.

Embedding (lookups of id 0 give zero vectors, as the JAX package does at
call time; this is not torch's ``padding_idx``) or a Linear input ->
positional encoding -> N layers -> LayerNorm. The transformer stack adds
the alpha-scaled absolute encoding; the conformer stack hands the
relative table to every layer's attention. Accent embeddings,
intermediate taps and the CTC tap come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.layers import (
    ConformerEncoderLayer, EncoderLayer)
from transformer_tts_tpu_torch.ops.feedforward import LN_EPS
from transformer_tts_tpu_torch.ops.positional import (
    PositionalEncoder, RelativePositionalEncoder)


class _Stack(nn.Module):
    """Input, key lengths and the layer loop shared by both stacks."""

    def __init__(self, vocab_size: int, d_model: int, embedding: bool,
                 use_flash: bool, pe: nn.Module, layers):
        super().__init__()
        self.embedding = embedding
        self.use_flash = use_flash
        # vocab_size is the input width when embedding is False
        self.embed = (nn.Embedding(vocab_size, d_model) if embedding
                      else nn.Linear(vocab_size, d_model))
        self.pe = pe
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def _input(self, src: torch.Tensor) -> torch.Tensor:
        x = self.embed(src)
        if self.embedding:
            x = torch.where((src != 0)[..., None], x, torch.zeros_like(x))
        return x

    def _key_lengths(self, mask) -> Optional[torch.Tensor]:
        """The kernel path takes the prefix pad mask as per-row lengths."""
        if self.use_flash and mask is not None and mask.shape[1] == 1:
            return mask[:, 0, :].sum(-1).to(torch.int32)
        return None

    def _layers(self, x, mask, collect_attn, *pos, generator=None):
        k_len = self._key_lengths(mask)
        attns = []
        for layer in self.layers:
            x, attn = layer(x, *pos, mask, collect_attn=collect_attn,
                            k_len=k_len, generator=generator)
            if collect_attn:
                attns.append(attn)
        x = self.norm(x)
        return x, (torch.stack(attns, dim=1) if collect_attn else None)


class Encoder(_Stack):
    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, ff_kernel_size: int, concat_after: bool = False,
                 dropout: float = 0.1, embedding: bool = True,
                 use_flash: bool = False):
        super().__init__(
            vocab_size, d_model, embedding, use_flash,
            PositionalEncoder(d_model, dropout),
            (EncoderLayer(d_model, heads, ff_kernel_size, dropout,
                          concat_after=concat_after, use_flash=use_flash)
             for _ in range(n_layers)))

    def forward(self, src, mask, *, collect_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``src`` (B, T) ids or (B, T, C) features; ``mask`` (B, 1, T)
        bool; ``generator`` seeds the kernel path's dropout. Returns
        (x (B, T, d_model), attn (B, N, H, T, T) or None)."""
        return self._layers(self.pe(self._input(src)), mask, collect_attn,
                            generator=generator)


class ConformerEncoder(_Stack):
    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, dropout: float = 0.1, embedding: bool = True,
                 use_flash: bool = False):
        super().__init__(
            vocab_size, d_model, embedding, use_flash,
            RelativePositionalEncoder(d_model, dropout),
            (ConformerEncoderLayer(d_model, heads, dropout,
                                   use_flash=use_flash)
             for _ in range(n_layers)))

    def forward(self, src, mask, *, collect_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """As ``Encoder.forward``."""
        x, pos_emb = self.pe(self._input(src))
        return self._layers(x, mask, collect_attn, pos_emb,
                            generator=generator)
