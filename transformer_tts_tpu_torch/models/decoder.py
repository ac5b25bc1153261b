"""The AR mel decoder stack (the port of ``Decoder``,
transformer_tts_tpu/models/decoder.py:26-107).

DecoderPreNet -> alpha-scaled positional encoding (from the decode step's
row in the cached mode) -> N x DecoderLayer -> LayerNorm. Two modes:

* the whole sequence (teacher forcing): with ``use_flash`` the masked
  self-attention takes K3 with ``self_k_len``, the last row of the
  (B, T, T) pad-and-causal mask (= each row's number of decoder groups),
  and the cross-attention takes K1/K2 over ``cross_k_len`` when the text
  bucket reaches ``FLASH_MIN_KEY_LEN``;
* one decode step with per-layer KV caches (``caches``, ``cache_index``)
  and the cross-attention K/V of ``precompute_cross_kv``: no kernel, as
  the cache turns it off (the JAX package's rule).

With ``spk_emb_dim`` every layer has a ``SpeakerBias``; the caller
computes the layers' biases once (``speaker_biases``) and passes them to
``forward``, so that a decode computes them once per call rather than at
every step, as the JAX package does: the bias is the same at every step.

``output_type`` (the discrete mode) gives the prenet an embedding fc1
over ``mel_dim`` codes: the (B, T, S) int code streams become (B, T, S,
d) and are summed over the streams before the positional encoding
(the JAX file's :72-73).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.layers import DecoderLayer
from transformer_tts_tpu_torch.models.prenets import DecoderPreNet
from transformer_tts_tpu_torch.ops.feedforward import LN_EPS
from transformer_tts_tpu_torch.ops.positional import PositionalEncoder


class Decoder(nn.Module):
    def __init__(self, mel_dim: int, d_model: int, n_layers: int,
                 heads: int, ff_kernel_size: int, concat_after: bool = False,
                 dropout: float = 0.1, dropout_prenet: float = 0.5,
                 use_flash: bool = False, spk_emb_dim: Optional[int] = None,
                 output_type: bool = False):
        super().__init__()
        self.use_flash = use_flash
        self.output_type = output_type
        self.decoder_prenet = DecoderPreNet(mel_dim, d_model,
                                            dropout=dropout_prenet,
                                            output_type=output_type)
        self.pe = PositionalEncoder(d_model, dropout)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, heads, ff_kernel_size, dropout,
                         concat_after=concat_after, use_flash=use_flash,
                         spk_emb_dim=spk_emb_dim)
            for _ in range(n_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def precompute_cross_kv(self, e_outputs: torch.Tensor):
        """Per-layer (k, v) cross-attention tensors, computed once."""
        return tuple(layer.cross_kv(e_outputs) for layer in self.layers)

    def speaker_biases(self, spk_emb: Optional[torch.Tensor]):
        """Each layer's (B, 1, d) speaker bias of ``spk_emb``, or None for a
        model without speaker layers or no speaker."""
        if spk_emb is None or self.layers[0].spk_bias is None:
            return None
        return tuple(layer.spk_bias(spk_emb) for layer in self.layers)

    def _key_lengths(self, src_mask, trg_mask):
        """(self_k_len, cross_k_len) for the kernel paths, or None."""
        if not self.use_flash:
            return None, None
        cross = self_len = None
        if src_mask is not None and src_mask.shape[1] == 1:
            cross = src_mask[:, 0, :].sum(-1).to(torch.int32)
        if trg_mask is not None and trg_mask.dim() == 3 \
                and trg_mask.shape[1] == trg_mask.shape[2]:
            # the last row of the pad-and-causal mask is the pad mask
            self_len = trg_mask[:, -1, :].sum(-1).to(torch.int32)
        return self_len, cross

    def forward(self, trg, e_outputs, src_mask, trg_mask, spk_biases=None,
                *, collect_attn: bool = False, caches=None, cache_index=None,
                pos_offset=0, cross_kvs=None,
                generator: Optional[torch.Generator] = None):
        """``trg`` (B, T, mel) -> (x (B, T, d_model), self-attention maps,
        cross-attention maps), the maps (B, N, H, T, T_k) only with
        ``collect_attn``; ``spk_biases`` from ``speaker_biases``. With
        ``caches`` (a tuple of per-layer (k, v)
        caches, updated in place; ``trg`` then the (B, 1, mel) step input
        and ``trg_mask`` hiding the cache rows past ``cache_index``) no
        kernel runs."""
        x = self.decoder_prenet(trg)
        if self.output_type:
            x = x.sum(dim=2)
        x = self.pe(x, offset=pos_offset)
        self_k_len, cross_k_len = (None, None) if caches is not None \
            else self._key_lengths(src_mask, trg_mask)
        attns_self, attns_cross = [], []
        for i, layer in enumerate(self.layers):
            x, a1, a2 = layer(
                x, e_outputs, src_mask, trg_mask,
                spk_biases[i] if spk_biases is not None else None,
                collect_attn=collect_attn,
                self_cache=caches[i] if caches is not None else None,
                cross_cache=cross_kvs[i] if cross_kvs is not None else None,
                cache_index=cache_index, self_k_len=self_k_len,
                cross_k_len=cross_k_len, generator=generator)
            if collect_attn:
                attns_self.append(a1)
                attns_cross.append(a2)
        x = self.norm(x)
        a_self = torch.stack(attns_self, 1) if collect_attn else None
        a_cross = torch.stack(attns_cross, 1) if collect_attn else None
        return x, a_self, a_cross
