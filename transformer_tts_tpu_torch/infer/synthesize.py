"""FastSpeech 2 synthesis (the port of ``denormalize``,
``sample_perturbation`` and ``synthesize_fastspeech2``,
transformer_tts_tpu/infer/synthesize.py:39-87).

One non-autoregressive forward in eval mode; the optional pitch/duration
perturbation factors come from {0.8, 0.9, 1.0, 1.1, 1.2}; the mel is
de-normalized as ``mel * sqrt(var) + mean`` on the device. The AR decode
loop comes with the AR slice of the port.
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import torch

from transformer_tts_tpu_torch.models.fastspeech2 import FastSpeech2
from transformer_tts_tpu_torch.ops.masks import pad_mask

PERTURBATION_CHOICES = (0.8, 0.9, 1.0, 1.1, 1.2)


def sample_perturbation(rng: Optional[random.Random] = None) -> float:
    r = rng or random
    return r.choice(PERTURBATION_CHOICES)


def denormalize(mel: torch.Tensor, mean: torch.Tensor,
                var: torch.Tensor) -> torch.Tensor:
    return mel * torch.sqrt(var) + mean


@torch.inference_mode()
def synthesize_fastspeech2(
    model: FastSpeech2, text: torch.Tensor, pos_text: torch.Tensor,
    max_frames: int, mean: Optional[torch.Tensor] = None,
    var: Optional[torch.Tensor] = None, *, pitch_scale: float = 1.0,
    duration_scale: float = 1.0, use_prenet: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward; returns (mel (B, T, mel), mel_len (B,), durations (B, L)).

    ``durations`` are the unscaled predictions, 0 on padded phones, as
    the JAX function returns them.
    """
    model.eval()
    src_mask = pad_mask(pos_text)
    out = model(text, src_mask, max_frames, pitch_scale=pitch_scale,
                duration_scale=duration_scale)
    mel = out.mel_pre if use_prenet or out.mel_post is None else out.mel_post
    if mean is not None and var is not None:
        mel = denormalize(mel, mean, var)
    durations = torch.round(
        torch.exp(out.log_duration.float()) - model.log_offset).clamp(min=0)
    durations = torch.where(src_mask[:, 0, :], durations,
                            torch.zeros_like(durations))
    return mel, out.mel_len, durations.to(torch.int32)
