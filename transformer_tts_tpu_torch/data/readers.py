"""Mel reading and per-corpus normalisation (the port of
transformer_tts_tpu/data/readers.py: ``load_mel`` for ``.npy`` files and
``Normalizer``, :30-72).

``Normalizer`` applies ``(mel - mean) / sqrt(var)`` to training mels, and
hands synthesis the mean/var arrays that ``infer/synthesize.denormalize``
applies on the device. HTK and torch-saved ``.mel`` feature files come
with the features slice (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_mel(mel_name: str, mel_dim: int) -> np.ndarray:
    """(T, mel_dim) float32 mel from a ``.npy`` file."""
    if ".npy" not in mel_name:
        from transformer_tts_tpu_torch.models.fastspeech2 import later_slice
        later_slice(f"reading {mel_name!r} (htk / .mel feature files)",
                    "features and vocoder")
    mel = np.load(mel_name)
    if mel.shape[-1] != mel_dim:
        mel = mel.reshape(-1, mel_dim)
    return np.asarray(mel, np.float32)


class Normalizer:
    """Per-corpus mean/var normalisation; a no-op without both files."""

    def __init__(self, mean_file: Optional[str], var_file: Optional[str],
                 mel_dim: int):
        if mean_file is not None and var_file is not None:
            self.mean = np.load(mean_file).reshape(-1, mel_dim)
            self.var = np.load(var_file).reshape(-1, mel_dim)
        else:
            self.mean = self.var = None

    def __call__(self, mel: np.ndarray) -> np.ndarray:
        if self.mean is None:
            return mel
        return (mel - self.mean) / np.sqrt(self.var)

    def arrays(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        return self.mean, self.var
