"""Padding, causal and band masks (the port of
transformer_tts_tpu/ops/masks.py:24-79).

All masks are boolean, True = attend; (B, 1, T) for a pad mask. The
attention op turns False into a -1e4 logit fill.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pad_mask(pos: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """(B, T) positions (1-based; 0 = padding) -> (B, 1, T) bool mask."""
    return (pos != pad)[:, None, :]


def no_peek_mask(size: int, device=None) -> torch.Tensor:
    """(1, T, T) lower-triangular causal mask: row r sees columns <= r."""
    r = torch.arange(size, device=device)
    return (r[:, None] >= r[None, :])[None]


def band_mask(size: int, context_len: int, device=None) -> torch.Tensor:
    """(1, T, T) band-diagonal mask, ``context_len`` wide and centred on
    the diagonal (the reference's ``fix_mask``)."""
    r = torch.arange(size, device=device)
    half = (context_len - 1) // 2
    diff = r[:, None] - r[None, :]
    return ((diff >= -half) & (diff <= half))[None]


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True for the first lengths[b]
    frames (the strict ``<`` of the JAX package, not the reference's
    off-by-one ``<=``)."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids < lengths[:, None]


def create_masks(
    pos_text: torch.Tensor,
    pos_mel: Optional[torch.Tensor],
    model: str = "fastspeech2",
    fix_mask: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(src_mask, trg_mask).

    * FastSpeech 2: trg_mask is the (B, 1, T_mel) pad mask.
    * AR Transformer-TTS: trg_mask = pad AND no-peek, (B, T_mel, T_mel).
    * ``fix_mask`` ANDs a band-diagonal window into src_mask, which then
      is (B, L, L) and keeps its attention on the masked path.
    """
    src_mask = pad_mask(pos_text)
    if fix_mask is not None:
        src_mask = src_mask & band_mask(pos_text.shape[1], fix_mask,
                                        pos_text.device)
    if pos_mel is None:
        return src_mask, None
    trg_pad = pad_mask(pos_mel)
    if model.lower() in ("fastspeech2", "lightspeech"):
        return src_mask, trg_pad
    return src_mask, trg_pad & no_peek_mask(pos_mel.shape[1], pos_mel.device)
