"""Log-mel features and Griffin-Lim (the port of
transformer_tts_tpu/ops/melspectrogram.py: ``hz_to_mel``, ``mel_to_hz``,
``mel_filterbank``, ``log_mel_spectrogram``, ``compute_corpus_stats``
:25-113, ``_stft``, ``_istft`` and ``griffin_lim_from_log_mel`` :116-199).

The JAX package runs these as XLA (``jnp.fft``, a scatter-add); here they
are library PyTorch: ``torch.fft`` (cuFFT on the card) and ``F.fold`` for
the overlap-add. The framing is the JAX package's: a reflect pad of
``n_fft // 2`` on each side, frames every ``hop_length`` samples, so an
input of N samples gives T = N // hop_length + 1 frames; the periodic Hann
window ``np.hanning(n + 1)[:-1]``, zero-padded to ``n_fft`` in the middle
when ``win_length < n_fft``; the power spectrum; the HTK triangular
filterbank (numpy, a copy of the JAX package's); ``log(max(mel, 1e-10))``.

Griffin-Lim maps the mel power back to linear frequency with the
row-normalized transposed filterbank, starts from zero phase, runs
``n_iter`` rounds of iSTFT then STFT, and peak-normalizes to 0.95.

The window and the filterbanks are built once per shape and device
(``functools.lru_cache``) and shared by every later call; the callers
never write to them.

The reflect pad needs more samples than it pads (``jnp.pad`` reflects
again past that, torch's pad raises): shorter audio raises ``ValueError``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hz_to_mel(f):
    """HTK mel scale (2595 * log10(1 + f/700))."""
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: float,
                   fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) triangular filter matrix (HTK mel scale)."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_mels, n_bins), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def _cached_on(device, array: np.ndarray) -> torch.Tensor:
    # an ordinary tensor even when first asked for under inference_mode,
    # so that the train step may save it for its backward
    with torch.inference_mode(False):
        return torch.as_tensor(array, device=device)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """The periodic Hann window of ``win_length``, zero-padded to ``n_fft``
    with the odd sample on the right."""
    window = np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return _cached_on(device, window)


@functools.lru_cache(maxsize=None)
def filterbank_on(device, n_mels: int, n_fft: int, sample_rate: float,
                  fmin: float, fmax: Optional[float],
                  pseudo_inverse: bool = False) -> torch.Tensor:
    """``mel_filterbank`` on ``device``, or with ``pseudo_inverse`` its
    row-normalized transpose (n_fft//2 + 1, n_mels)."""
    fb = mel_filterbank(n_mels, n_fft, sample_rate, fmin, fmax)
    if pseudo_inverse:
        fb = fb.T / np.maximum(fb.sum(axis=1)[None, :], 1e-8)
    return _cached_on(device, fb)


def frame(audio: torch.Tensor, frame_length: int, hop_length: int,
          center: bool) -> torch.Tensor:
    """(B, N) -> (B, T, frame_length), reflect-padded by frame_length // 2
    on each side when ``center``."""
    if center:
        pad = frame_length // 2
        if audio.shape[-1] <= pad:
            raise ValueError(
                f"{audio.shape[-1]} samples: the reflect pad of {pad} needs "
                f"at least {pad + 1} (the JAX package reflects again past "
                "the input's ends; the port does not)")
        audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    return audio.unfold(-1, frame_length, hop_length)


def log_mel_spectrogram(
    audio: torch.Tensor,
    *,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: Optional[int] = None,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    center: bool = True,
    log_offset: float = 1e-10,
) -> torch.Tensor:
    """(..., N) waveform -> (..., T, n_mels) natural-log mel power, in fp32
    on the waveform's device. T = N // hop_length + 1 with ``center``."""
    win_length = win_length or n_fft
    squeeze = audio.dim() == 1
    if squeeze:
        audio = audio[None]
    frames = frame(audio.float(), n_fft, hop_length, center)
    window = hann_window(win_length, n_fft, audio.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2             # (B, T, n_bins)
    fb = filterbank_on(audio.device, n_mels, n_fft, sample_rate, fmin,
                       fmax)
    out = torch.log(torch.clamp(power @ fb.T, min=log_offset))
    return out[0] if squeeze else out


def compute_corpus_stats(mels: torch.Tensor, lengths: torch.Tensor):
    """Per-corpus (mean, var) over the valid frames of a padded (B, T, D)
    batch."""
    valid = (torch.arange(mels.shape[1], device=mels.device)[None, :]
             < lengths[:, None])[..., None]
    n = torch.clamp(valid.sum(), min=1)
    mean = (mels * valid).sum(dim=(0, 1)) / n
    var = (((mels - mean) ** 2) * valid).sum(dim=(0, 1)) / n
    return mean, var


def stft(audio: torch.Tensor, n_fft: int, hop_length: int,
         window: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B, T, n_bins) complex, center-padded framing."""
    frames = frame(audio, n_fft, hop_length, center=True)
    return torch.fft.rfft(frames * window, n=n_fft, dim=-1)


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T, n) -> (B, (T - 1) * hop + n), each frame added at t * hop."""
    b, t, n = frames.shape
    total = (t - 1) * hop_length + n
    out = F.fold(frames.transpose(1, 2), output_size=(1, total),
                 kernel_size=(1, n), stride=(1, hop_length))
    return out.reshape(b, total)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int,
          window: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(B, T, n_bins) complex -> (B, n_samples): windowed overlap-add over
    the window's square sum (floor 1e-8), cropped past the center pad."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * window
    audio = _overlap_add(frames, hop_length)
    wsum = _overlap_add((window ** 2).expand(1, frames.shape[1], n_fft),
                        hop_length)
    audio = audio / torch.clamp(wsum, min=1e-8)
    pad = n_fft // 2
    return audio[:, pad: pad + n_samples]


def griffin_lim_from_log_mel(
    log_mel: torch.Tensor,
    *,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    n_mels: int = 80,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    n_iter: int = 32,
    n_samples: Optional[int] = None,
    power: float = 2.0,
) -> torch.Tensor:
    """(B, T, n_mels) natural-log mel -> (B, n_samples) waveform, by
    ``n_iter`` rounds of Griffin-Lim from zero phase; T frames give
    (T - 1) * hop_length samples unless ``n_samples`` says otherwise."""
    squeeze = log_mel.dim() == 2
    if squeeze:
        log_mel = log_mel[None]
    t = log_mel.shape[1]
    if n_samples is None:
        n_samples = (t - 1) * hop_length
    device = log_mel.device

    # row-normalized transpose as pseudo-inverse
    fb_t = filterbank_on(device, n_mels, n_fft, sample_rate, fmin, fmax,
                         pseudo_inverse=True)
    mel_power = torch.exp(log_mel.float())
    lin_power = mel_power @ fb_t.T
    mag = torch.clamp(lin_power, min=1e-10) ** (1.0 / power)

    window = hann_window(n_fft, n_fft, device)
    phase = torch.zeros_like(mag)
    for _ in range(n_iter):
        audio = istft(torch.polar(mag, phase), n_fft, hop_length, window,
                      n_samples)
        phase = torch.angle(stft(audio, n_fft, hop_length, window))
    audio = istft(torch.polar(mag, phase), n_fft, hop_length, window,
                  n_samples)
    peak = audio.abs().amax(dim=1, keepdim=True)
    audio = audio / torch.clamp(peak, min=1e-8) * 0.95
    return audio[0] if squeeze else audio
