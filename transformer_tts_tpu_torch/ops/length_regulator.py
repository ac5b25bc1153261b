"""Duration-driven frame expansion (the port of
transformer_tts_tpu/ops/length_regulator.py:27-81).

    ends   = cumsum(durations)                       # (B, L)
    phone  = searchsorted(ends, t, right=True)       # frame t -> phone
    out[t] = x[phone[t]]                             # one gather
    frames >= mel_len are zero; mel_len is clipped to max_frames.

Phone i covers frames [ends[i-1], ends[i]); padded phones (duration 0)
cover nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch


def length_regulate(
    x: torch.Tensor, durations: torch.Tensor, max_frames: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Expand (B, L, D) phone features by (B, L) integer durations.

    Returns ``(out (B, T, D), mel_len (B,), mel_pos (B, T))`` with
    T = ``max_frames``; ``mel_pos`` is 1-based and 0 past ``mel_len``.
    """
    b, n_phones = durations.shape
    ends = torch.cumsum(durations.long(), dim=1)
    mel_len = ends[:, -1].clamp(max=max_frames)
    t = torch.arange(max_frames, device=x.device)
    phone = torch.searchsorted(ends, t[None, :].expand(b, -1).contiguous(),
                               right=True)
    phone = phone.clamp(max=n_phones - 1)
    out = torch.gather(x, 1, phone[:, :, None].expand(-1, -1, x.shape[2]))
    valid = t[None, :] < mel_len[:, None]
    out = torch.where(valid[:, :, None], out, torch.zeros_like(out))
    mel_pos = torch.where(valid, t[None, :] + 1, torch.zeros_like(t[None, :]))
    return out, mel_len, mel_pos


def durations_from_log(log_duration: torch.Tensor, log_offset: float = 1.0,
                       scale: float = 1.0) -> torch.Tensor:
    """``clamp(round(exp(logd) - log_offset), 0)``, then ``round(d * scale)``
    when a perturbation scale is given. ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    d = torch.round(torch.exp(log_duration) - log_offset).clamp(min=0)
    if scale != 1.0:
        d = torch.round(d * scale)
    return d.long()
