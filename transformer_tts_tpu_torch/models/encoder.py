"""Encoder stacks (the port of ``Encoder`` and ``ConformerEncoder``,
transformer_tts_tpu/models/encoder.py:49-174), used for the text encoder
and for FastSpeech 2's "decoder" over mel frames.

Embedding (lookups of id 0 give zero vectors, as the JAX package does at
call time; this is not torch's ``padding_idx``) or a Linear input ->
positional encoding -> N layers -> LayerNorm. The transformer stack adds
the alpha-scaled absolute encoding; the conformer stack hands the
relative table to every layer's attention.

Conditioning, as in the JAX stacks (encoder.py:104-109, :143-145,
:167-169): ``spk_emb_dim`` gives every layer its speaker conditioning
(models/layers.py); ``accent_emb`` adds a per-phone accent embedding
``acc_embed`` ((B, L) ids, no padding row), after the layer loop and
before the final norm in the transformer stack (5 accents), at the input
in the conformer stack (13 accents); ``ctc_out`` taps ``ctc_linear`` (d
-> ``ctc_classes``) after layer ``min(ctc_layer, n_layers - 1)`` and the
stack returns its logits third. The transformer stack's
``intermediate_layers_out`` (the JAX file's :62-63, :76-77, :87-113)
taps ``intermediate[i]`` (d -> 80) after each named layer i and returns
the list of taps, in layer order, third; it excludes ``ctc_out``
(``ValueError``). The mel-to-mel students build it (models/postnets.py).
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


CTC_LAYER = 2
INTERMEDIATE_DIM = 80


class _Stack(nn.Module):
    """Input, key lengths and the layer loop shared by both stacks."""

    def __init__(self, vocab_size: int, d_model: int, embedding: bool,
                 use_flash: bool, pe: nn.Module, layers,
                 n_accents: Optional[int] = None, ctc_out: bool = False,
                 ctc_classes: int = 152,
                 intermediate_layers_out: Optional[tuple] = None):
        super().__init__()
        if ctc_out and intermediate_layers_out:
            raise ValueError("ctc_out and intermediate_layers_out taps are "
                             "exclusive")
        self.embedding = embedding
        self.use_flash = use_flash
        # vocab_size is the input width when embedding is False
        self.embed = (nn.Embedding(vocab_size, d_model) if embedding
                      else nn.Linear(vocab_size, d_model))
        self.pe = pe
        self.layers = nn.ModuleList(layers)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.acc_embed = (nn.Embedding(n_accents, d_model)
                          if n_accents is not None else None)
        self.ctc_linear = (nn.Linear(d_model, ctc_classes) if ctc_out
                           else None)
        self.ctc_at = min(CTC_LAYER, len(self.layers) - 1)
        self.intermediate = (
            nn.ModuleDict({str(i): nn.Linear(d_model, INTERMEDIATE_DIM)
                           for i in range(len(self.layers))
                           if i in intermediate_layers_out})
            if intermediate_layers_out else None)

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

    def _accent(self, accent):
        return (self.acc_embed(accent)
                if self.acc_embed is not None and accent is not None
                else None)

    def _layers(self, x, mask, collect_attn, *pos, spk_emb=None,
                accent_emb=None, generator=None):
        k_len = self._key_lengths(mask)
        attns = []
        taps = []
        ctc_logits = None
        for i, layer in enumerate(self.layers):
            x, attn = layer(x, *pos, mask, spk_emb,
                            collect_attn=collect_attn, k_len=k_len,
                            generator=generator)
            if collect_attn:
                attns.append(attn)
            if self.intermediate is not None and str(i) in self.intermediate:
                taps.append(self.intermediate[str(i)](x))
            if self.ctc_linear is not None and i == self.ctc_at:
                ctc_logits = self.ctc_linear(x)
        if accent_emb is not None:
            x = x + accent_emb
        x = self.norm(x)
        attn = torch.stack(attns, dim=1) if collect_attn else None
        if self.intermediate is not None:
            return x, attn, taps
        if self.ctc_linear is not None:
            return x, attn, ctc_logits
        return x, attn


class Encoder(_Stack):
    N_ACCENTS = 5

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, ff_kernel_size: int, concat_after: bool = False,
                 dropout: float = 0.1, embedding: bool = True,
                 use_flash: bool = False, spk_emb_dim: Optional[int] = None,
                 accent_emb: bool = False, ctc_out: bool = False,
                 ctc_classes: int = 152,
                 intermediate_layers_out: Optional[tuple] = None):
        super().__init__(
            vocab_size, d_model, embedding, use_flash,
            PositionalEncoder(d_model, dropout),
            (EncoderLayer(d_model, heads, ff_kernel_size, dropout,
                          concat_after=concat_after, use_flash=use_flash,
                          spk_emb_dim=spk_emb_dim)
             for _ in range(n_layers)),
            self.N_ACCENTS if accent_emb else None, ctc_out, ctc_classes,
            intermediate_layers_out)

    def forward(self, src, mask, spk_emb=None, accent=None, *,
                collect_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """``src`` (B, T) ids or (B, T, C) features; ``mask`` (B, 1, T)
        bool; ``spk_emb`` (B,) ids or (B, 512) x-vectors, ``accent``
        (B, T) ids; ``generator`` seeds the kernel path's dropout. Returns
        (x (B, T, d_model), attn (B, N, H, T, T) or None[, ctc_logits or
        the list of taps])."""
        return self._layers(self.pe(self._input(src)), mask, collect_attn,
                            spk_emb=spk_emb, accent_emb=self._accent(accent),
                            generator=generator)


class ConformerEncoder(_Stack):
    N_ACCENTS = 13

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, dropout: float = 0.1, embedding: bool = True,
                 use_flash: bool = False, spk_emb_dim: Optional[int] = None,
                 accent_emb: bool = False, ctc_out: bool = False,
                 ctc_classes: int = 152):
        super().__init__(
            vocab_size, d_model, embedding, use_flash,
            RelativePositionalEncoder(d_model, dropout),
            (ConformerEncoderLayer(d_model, heads, dropout,
                                   use_flash=use_flash,
                                   spk_emb_dim=spk_emb_dim)
             for _ in range(n_layers)),
            self.N_ACCENTS if accent_emb else None, ctc_out, ctc_classes)

    def forward(self, src, mask, spk_emb=None, accent=None, *,
                collect_attn: bool = False,
                generator: Optional[torch.Generator] = None):
        """As ``Encoder.forward``; the accent goes in at the input."""
        x = self._input(src)
        accent_emb = self._accent(accent)
        if accent_emb is not None:
            x = x + accent_emb
        x, pos_emb = self.pe(x)
        return self._layers(x, mask, collect_attn, pos_emb, spk_emb=spk_emb,
                            generator=generator)


class EncoderPostprocessing(_Stack):
    """The JAX package's ``EncoderPostprocessing`` (its encoder.py:
    177-236), the reference's encoder with gender, speaker-id and accent
    tables added to the input and a CTC tap after layer ``ctc_layer``;
    no model builds it. -> (x, ctc logits or None, attention maps or
    None)."""
    N_ACCENTS = 5

    def __init__(self, vocab_size: int, d_model: int, n_layers: int,
                 heads: int, ff_kernel_size: int, concat_after: bool = False,
                 dropout: float = 0.1, embedding: bool = True,
                 accent_emb: bool = False, gender_emb: bool = False,
                 speaker_emb: bool = False, n_speakers: int = 247,
                 ctc_out: bool = False, ctc_classes: int = 152,
                 ctc_layer: int = CTC_LAYER):
        super().__init__(
            vocab_size, d_model, embedding, False,
            PositionalEncoder(d_model, dropout),
            (EncoderLayer(d_model, heads, ff_kernel_size, dropout,
                          concat_after=concat_after)
             for _ in range(n_layers)),
            self.N_ACCENTS if accent_emb else None, ctc_out, ctc_classes)
        self.ctc_at = ctc_layer
        self.gender_embed = nn.Embedding(2, d_model) if gender_emb else None
        self.speaker_embed = (nn.Embedding(n_speakers, d_model)
                              if speaker_emb else None)

    def forward(self, src, mask, spk_emb=None, accent=None, gender=None, *,
                collect_attn: bool = False):
        x = self._input(src)
        accent_emb = self._accent(accent)
        if accent_emb is not None:
            x = x + accent_emb
        if self.gender_embed is not None:
            if gender is None:
                raise ValueError("gender_emb=True requires gender ids")
            x = x + self.gender_embed(gender)[:, None, :]
        if self.speaker_embed is not None:
            x = x + self.speaker_embed(spk_emb)[:, None, :]
        out = self._layers(self.pe(x), mask, collect_attn)
        x, attn = out[:2]
        return x, (out[2] if self.ctc_linear is not None else None), attn
