"""Transformer encoder stack (the port of ``Encoder``,
transformer_tts_tpu/models/encoder.py:49-116), shared by the text encoder
and FastSpeech 2's "decoder" over mel frames.

Embedding (lookups of id 0 give zero vectors, as the JAX package does at
call time; this is not torch's ``padding_idx``) or a Linear input ->
alpha-scaled positional encoding -> N x EncoderLayer -> LayerNorm.
Accent embeddings, intermediate taps and the CTC tap come with later
slices.
"""

from __future__ import annotations

import torch
from torch import nn

from transformer_tts_tpu_torch.models.layers import EncoderLayer
from transformer_tts_tpu_torch.ops.feedforward import LN_EPS
from transformer_tts_tpu_torch.ops.positional import PositionalEncoder


class Encoder(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, ff_kernel_size: int, concat_after: bool = False,
                 dropout: float = 0.1, embedding: bool = True,
                 use_flash: bool = False):
        super().__init__()
        self.embedding = embedding
        self.use_flash = use_flash
        # vocab_size is the input width when embedding is False
        self.embed = (nn.Embedding(vocab_size, d_model) if embedding
                      else nn.Linear(vocab_size, d_model))
        self.pe = PositionalEncoder(d_model, dropout)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, heads, ff_kernel_size, dropout,
                         concat_after=concat_after, use_flash=use_flash)
            for _ in range(n_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, mask, *, collect_attn: bool = False):
        """``src`` (B, T) ids or (B, T, C) features; ``mask`` (B, 1, T)
        bool. Returns (x (B, T, d_model), attn (B, N, H, T, T) or None)."""
        x = self.embed(src)
        if self.embedding:
            x = torch.where((src != 0)[..., None], x, torch.zeros_like(x))
        x = self.pe(x)
        # the kernel path takes the prefix pad mask as per-row lengths
        k_len = (mask[:, 0, :].sum(-1).to(torch.int32)
                 if self.use_flash and mask is not None
                 and mask.shape[1] == 1 else None)
        attns = []
        for layer in self.layers:
            x, attn = layer(x, mask, collect_attn=collect_attn, k_len=k_len)
            if collect_attn:
                attns.append(attn)
        x = self.norm(x)
        return x, (torch.stack(attns, dim=1) if collect_attn else None)
