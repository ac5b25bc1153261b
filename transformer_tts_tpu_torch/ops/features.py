"""Acoustic features: f0 by YIN, energy, and WAV reading (the port of
transformer_tts_tpu/ops/features.py: ``_frame``, ``energy_per_frame``,
``yin_f0``, ``read_wav``, :28-180).

Framed as ``log_mel_spectrogram`` (ops/melspectrogram.py), so the three
feature streams of a corpus stay aligned frame for frame:

* ``energy_per_frame``: the L2 norm of each frame's STFT magnitude;
* ``yin_f0``: YIN (de Cheveigné & Kawahara 2002) over frames of 2048
  samples: the difference function from one FFT cross-correlation per
  frame, the cumulative-mean-normalized difference (CMNDF), the first
  trough below ``threshold`` (else the global minimum), a parabolic shift
  clipped to ±0.5 samples, and 0 Hz where the best CMNDF is not below
  ``voicing_threshold`` or the frame is silent.

``read_wav`` uses the stdlib ``wave`` module: 8-bit unsigned and 16/32-bit
PCM, channels averaged to mono.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from transformer_tts_tpu_torch.ops.melspectrogram import frame, hann_window


def energy_per_frame(
    audio: torch.Tensor,
    *,
    n_fft: int = 1024,
    hop_length: int = 256,
    center: bool = True,
) -> torch.Tensor:
    """(..., N) waveform -> (..., T) per-frame STFT-magnitude L2 norm."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    frames = frame(audio.float(), n_fft, hop_length, center)
    window = hann_window(n_fft, n_fft, audio.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    energy = torch.sqrt((spec.real ** 2 + spec.imag ** 2).sum(dim=-1))
    return energy[0] if squeeze else energy


def yin_f0(
    audio: torch.Tensor,
    *,
    sample_rate: int = 22050,
    frame_length: int = 2048,
    hop_length: int = 256,
    f0_min: float = 71.0,
    f0_max: float = 795.8,
    threshold: float = 0.1,
    voicing_threshold: float = 0.45,
    center: bool = True,
) -> torch.Tensor:
    """(..., N) waveform -> (..., T) f0 in Hz (0.0 where unvoiced).

    d(tau) = sum_{j<H} (x[j] - x[j+tau])^2 with H = frame_length // 2, as
    e0 + e(tau) - 2 c(tau): the energies from a cumulative sum, c by FFT."""
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    device = audio.device
    half = frame_length // 2
    tau_min = max(int(sample_rate / f0_max), 2)
    tau_max = min(int(np.ceil(sample_rate / f0_min)), half - 1)

    frames = frame(audio.float(), frame_length, hop_length, center)
    b, t, w = frames.shape
    x = frames.reshape(b * t, w)

    n_fft = int(2 ** np.ceil(np.log2(w + half)))
    fx = torch.fft.rfft(x, n=n_fft)
    fh = torch.fft.rfft(x[:, :half], n=n_fft)
    corr = torch.fft.irfft(fx * fh.conj(), n=n_fft)[:, :tau_max + 1]
    csum = torch.cumsum(F.pad(x * x, (1, 0)), dim=-1)   # (B*T, W+1)
    e0 = csum[:, half] - csum[:, 0]                     # energy of x[0:H]
    taus = torch.arange(tau_max + 1, device=device)
    e_tau = csum[:, taus + half] - csum[:, taus]        # of x[tau:tau+H]
    d = torch.clamp(e0[:, None] + e_tau - 2.0 * corr, min=0.0)

    # CMNDF
    run = torch.cumsum(d[:, 1:], dim=-1)
    lags = torch.arange(1, tau_max + 1, device=device, dtype=torch.float32)
    cmndf = d[:, 1:] * lags / torch.clamp(run, min=1e-12)
    cmndf = torch.cat([torch.ones_like(cmndf[:, :1]), cmndf], dim=-1)

    cm = torch.where((taus >= tau_min)[None, :], cmndf,
                     torch.full_like(cmndf, float("inf")))
    # candidate lags are the CMNDF's troughs
    left = F.pad(cm[:, :-1], (1, 0), value=float("inf"))
    right = F.pad(cm[:, 1:], (0, 1), value=float("inf"))
    trough = (cm <= left) & (cm <= right)
    below = trough & (cm < threshold)
    # argmax and argmin give the first extremum, as jnp's do
    first_below = below.to(torch.int32).argmax(dim=-1)
    best = cm.argmin(dim=-1)
    tau = torch.where(below.any(dim=-1), first_below, best)

    # parabolic interpolation around the chosen lag
    t0 = torch.clamp(tau, tau_min, tau_max)
    tm = torch.clamp(t0 - 1, 0, tau_max)
    tp = torch.clamp(t0 + 1, 0, tau_max)
    rows = torch.arange(b * t, device=device)
    dm, d0, dp = cmndf[rows, tm], cmndf[rows, t0], cmndf[rows, tp]
    denom = dm + dp - 2.0 * d0
    curved = denom.abs() > 1e-12
    shift = torch.where(curved, 0.5 * (dm - dp) / torch.where(
        curved, denom, torch.ones_like(denom)), torch.zeros_like(denom))
    period = t0.float() + torch.clamp(shift, -0.5, 0.5)

    voiced = (cm[rows, t0] < voicing_threshold) & (e0 > 1e-8)
    f0 = torch.where(voiced, sample_rate / torch.clamp(period, min=1.0),
                     torch.zeros_like(period))
    f0 = f0.reshape(b, t)
    return f0[0] if squeeze else f0


def read_wav(path: str,
             expected_rate: Optional[int] = None) -> "tuple[np.ndarray, int]":
    """PCM WAV -> (float32 mono waveform in [-1, 1], sample_rate)."""
    import wave

    with wave.open(path, "rb") as fh:
        rate = fh.getframerate()
        n = fh.getnframes()
        width = fh.getsampwidth()
        channels = fh.getnchannels()
        raw = fh.readframes(n)
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(
            f"{path}: sample rate {rate} != expected {expected_rate} "
            "(resample offline; the extractor does not resample)")
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128) / 128.0
    else:
        raise ValueError(f"{path}: unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """A mono waveform in [-1, 1] (clipped) -> a 16-bit PCM WAV."""
    import wave

    pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "wb") as fh:
        fh.setnchannels(1)
        fh.setsampwidth(2)
        fh.setframerate(sample_rate)
        fh.writeframes(pcm.tobytes())
