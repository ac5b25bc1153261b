"""Encoder and decoder blocks (the port of ``EncoderLayer``,
``ConformerEncoderLayer`` and ``DecoderLayer``,
transformer_tts_tpu/models/layers.py:53-202).

Transformer: norm -> self-attention -> +residual; norm -> conv FFN ->
+residual. Conformer: x + 0.5 * FF1(x); h = norm(x); h + conv(h) ->
relative self-attention -> +residual (around the conv too); x + FF2(x),
not halved. AR decoder (pre-norm): norm -> masked self-attention
(``attn_1``: causal, or the decode step's KV cache) -> +residual; norm ->
cross-attention over the encoder output (``attn_2``, optionally on
precomputed K/V) -> +residual; norm -> conv FFN -> +residual.

Speaker conditioning (``spk_emb_dim`` set and a speaker given), as the
JAX package places it (its layers.py:34-50, :79-81, :116-124, :197-198):
``SpeakerBias`` (softsign of a projected speaker embedding, (B, 1, d))
is added after ``norm_2`` of ``EncoderLayer`` and after ``norm_3`` of
``DecoderLayer``, to the FFN's input only, not to the residual; the
conformer adds its raw ``multi_emb`` embedding, with no softsign, to the
residual stream between the attention and ``ff_2``. ``spk_emb_dim`` 512
means x-vectors ((B, 512) floats, a Linear); any other value is the row
count of a speaker-id table ((B,) ids, an Embedding).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from transformer_tts_tpu_torch.ops.attention import (
    MultiHeadAttention, RelativeMultiHeadAttention)
from transformer_tts_tpu_torch.ops.feedforward import (
    LN_EPS, ConformerConvModule, ConformerFeedForward, ConvFeedForward)

XVECTOR_DIM = 512          # spk_emb_dim of x-vector models


def speaker_embedding(spk_emb_dim: int, d_model: int) -> nn.Module:
    """A Linear of x-vectors when ``spk_emb_dim`` is 512, else a table of
    ``spk_emb_dim`` speaker ids (lookups of id 0 included: no padding
    row)."""
    if spk_emb_dim == XVECTOR_DIM:
        return nn.Linear(spk_emb_dim, d_model)
    return nn.Embedding(spk_emb_dim, d_model)


class SpeakerBias(nn.Module):
    """softsign(W @ embed(spk)) as a (B, 1, d_model) bias; W has no
    bias."""

    def __init__(self, d_model: int, spk_emb_dim: int):
        super().__init__()
        self.multi_emb = speaker_embedding(spk_emb_dim, d_model)
        self.speaker_L_l1_es = nn.Linear(d_model, d_model, bias=False)

    def forward(self, spk_emb: torch.Tensor) -> torch.Tensor:
        return F.softsign(self.speaker_L_l1_es(
            self.multi_emb(spk_emb)))[:, None, :]


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ff_kernel_size: int,
                 dropout: float = 0.1, concat_after: bool = False,
                 use_flash: bool = False,
                 spk_emb_dim: Optional[int] = None):
        super().__init__()
        self.spk_bias = (SpeakerBias(d_model, spk_emb_dim)
                         if spk_emb_dim is not None else None)
        self.norm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn = MultiHeadAttention(heads, d_model, dropout,
                                       concat_after=concat_after,
                                       use_flash=use_flash)
        self.ff = ConvFeedForward(d_model, ff_kernel_size, dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask, spk_emb=None, *, collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.norm_1(x)
        out, attn = self.attn(h, h, h, mask, collect_attn=collect_attn,
                              k_len=k_len, generator=generator)
        x = x + self.dropout(out)
        h = self.norm_2(x)
        if self.spk_bias is not None and spk_emb is not None:
            h = h + self.spk_bias(spk_emb)
        x = x + self.dropout(self.ff(h))
        return x, attn


class ConformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, dropout: float = 0.1,
                 use_flash: bool = False,
                 spk_emb_dim: Optional[int] = None):
        super().__init__()
        self.multi_emb = (speaker_embedding(spk_emb_dim, d_model)
                          if spk_emb_dim is not None else None)
        self.ff_1 = ConformerFeedForward(d_model, 2 * d_model, dropout)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.conv_module = ConformerConvModule(d_model, dropout=dropout)
        self.attn = RelativeMultiHeadAttention(heads, d_model, dropout,
                                               use_flash=use_flash)
        self.ff_2 = ConformerFeedForward(d_model, 2 * d_model, dropout)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, pos_emb, mask, spk_emb=None, *,
                collect_attn: bool = False,
                k_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """``generator`` seeds the relative kernel path's dropout
        (K4-d)."""
        x = x + 0.5 * self.ff_1(x)
        res = x
        h = self.norm(x)
        h = h + self.conv_module(h)
        out, attn = self.attn(h, h, h, pos_emb, mask,
                              collect_attn=collect_attn, k_len=k_len,
                              generator=generator)
        x = res + self.dropout(out)
        if self.multi_emb is not None and spk_emb is not None:
            x = x + self.multi_emb(spk_emb)[:, None, :]
        x = x + self.dropout(self.ff_2(x))
        return x, attn


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, heads: int, ff_kernel_size: int,
                 dropout: float = 0.1, concat_after: bool = False,
                 use_flash: bool = False,
                 spk_emb_dim: Optional[int] = None):
        super().__init__()
        self.spk_bias = (SpeakerBias(d_model, spk_emb_dim)
                         if spk_emb_dim is not None else None)
        self.norm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm_3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.attn_1 = MultiHeadAttention(heads, d_model, dropout,
                                         concat_after=concat_after,
                                         use_flash=use_flash)
        self.attn_2 = MultiHeadAttention(heads, d_model, dropout,
                                         concat_after=concat_after,
                                         use_flash=use_flash)
        self.ff = ConvFeedForward(d_model, ff_kernel_size, dropout)
        self.dropout = nn.Dropout(dropout)

    def cross_kv(self, e_outputs: torch.Tensor):
        """This layer's cross-attention (k, v), constant over a decode."""
        return self.attn_2.project_kv(e_outputs, e_outputs)

    def forward(self, x, e_outputs, src_mask, trg_mask, spk_bias=None, *,
                collect_attn: bool = False, self_cache=None,
                cross_cache=None, cache_index=None,
                self_k_len: Optional[torch.Tensor] = None,
                cross_k_len: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (x, attn_self, attn_cross); ``self_cache`` is updated
        in place. ``spk_bias`` is this layer's ``self.spk_bias(spk_emb)``,
        (B, 1, d), computed by the caller (once per decode, not per
        step)."""
        h = self.norm_1(x)
        out, attn_1 = self.attn_1(h, h, h, trg_mask,
                                  collect_attn=collect_attn,
                                  k_len=self_k_len, causal=True,
                                  generator=generator, cache=self_cache,
                                  cache_index=cache_index)
        x = x + self.dropout(out)
        h = self.norm_2(x)
        out, attn_2 = self.attn_2(h, e_outputs, e_outputs, src_mask,
                                  collect_attn=collect_attn,
                                  k_len=cross_k_len,
                                  precomputed_kv=cross_cache,
                                  generator=generator)
        x = x + self.dropout(out)
        h = self.norm_3(x)
        if spk_bias is not None:
            h = h + spk_bias
        x = x + self.dropout(self.ff(h))
        return x, attn_1, attn_2
