"""Padding masks (the port of transformer_tts_tpu/ops/masks.py:24-79).

All masks are boolean, True = attend; (B, 1, T) for a pad mask. The
attention op turns False into a -1e4 logit fill.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def pad_mask(pos: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """(B, T) positions (1-based; 0 = padding) -> (B, 1, T) bool mask."""
    return (pos != pad)[:, None, :]


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(src_mask, trg_mask) for the non-autoregressive models: two pad
    masks. The AR models' causal masks and ``fix_mask`` bands come with
    the AR slice."""
    if model.lower() not in ("fastspeech2", "lightspeech"):
        raise NotImplementedError(
            f"create_masks for {model!r}: the causal masks of the AR "
            "Transformer-TTS come with the AR slice of the port")
    src_mask = pad_mask(pos_text)
    if pos_mel is None:
        return src_mask, None
    return src_mask, pad_mask(pos_mel)
