"""Mel reading and per-corpus normalisation (the port of
transformer_tts_tpu/data/readers.py: ``load_htk``, ``load_mel`` and
``Normalizer``, :18-72).

``load_mel`` reads ``.npy`` files, HTK files (a 12-byte big-endian header,
then big-endian float32 frames) and torch-saved ``.mel`` tensors
((1, mel_dim, T), read with ``weights_only=True``). ``Normalizer`` applies
``(mel - mean) / sqrt(var)`` to training mels, and hands synthesis the
mean/var arrays that ``infer/synthesize.denormalize`` applies on the
device.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def load_htk(filename: str) -> np.ndarray:
    """Parse a 12-byte HTK header + big-endian float32 frames."""
    with open(filename, "rb") as fh:
        _, _, samp_size, _ = struct.unpack(">IIHH", fh.read(12))
        dat = np.fromfile(fh, dtype=">f4")
    veclen = samp_size // 4
    return dat.reshape(len(dat) // veclen, veclen).astype(np.float32)


def load_mel(mel_name: str, mel_dim: int) -> np.ndarray:
    """(T, mel_dim) float32 mel from a npy, htk or torch-saved mel file."""
    if ".npy" in mel_name:
        mel = np.load(mel_name)
        if mel.shape[-1] != mel_dim:
            mel = mel.reshape(-1, mel_dim)
        return np.asarray(mel, np.float32)
    if ".htk" in mel_name:
        return np.asarray(load_htk(mel_name)[:, :mel_dim], np.float32)
    if ".mel" in mel_name:
        import torch
        t = torch.load(mel_name, map_location="cpu", weights_only=True)
        return t.squeeze(0).transpose(0, 1).numpy().astype(np.float32)
    raise ValueError(f"unknown mel file extension: {mel_name}")


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
