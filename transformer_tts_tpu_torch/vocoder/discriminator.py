"""HiFi-GAN discriminators, used in training only (the port of
transformer_tts_tpu/vocoder/discriminator.py).

* ``MultiPeriodDiscriminator``: for each period p in (2, 3, 5, 7, 11) the
  waveform, reflect-padded to a multiple of p, is viewed as (B, 1, N/p,
  p) and run through (5, 1) convs with stride (3, 1), channels 32, 128,
  512, 1024, then a (5, 1) conv and a (3, 1) conv to one channel.
* ``MultiScaleDiscriminator``: three stacks of seven 1-D convs (grouped,
  kernels 15 and 41, strides 1, 2 and 4) at scales x1, x2 and x4, each
  scale an average pool (kernel 4, stride 2) of the one before.

Each returns a list of (logits (B, n), feature maps) per sub-discriminator,
in the JAX package's order (MPD's periods, then MSD's scales); a feature
map is NCHW (MPD) or NCL (MSD) where the JAX one is NHWC or NLC. Every
convolution and the pool pad as flax's ``"SAME"`` (``same_padding``); the
pool divides by its full window, padding included, as flax's
``avg_pool``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from transformer_tts_tpu_torch.vocoder.generator import (
    LRELU_SLOPE, SameConv1d, _wn, same_padding)

MSD_LAYERS = (  # (channels, kernel, stride, groups)
    (128, 15, 1, 1), (128, 41, 2, 4), (256, 41, 2, 16), (512, 41, 4, 16),
    (1024, 41, 4, 16), (1024, 41, 1, 16), (1024, 5, 1, 1))


class SameConv2dTime(nn.Conv2d):
    """A (k, 1) Conv2d with stride (s, 1) over (B, C, T, p), padded along
    T as flax's ``"SAME"``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1):
        super().__init__(in_ch, out_ch, (k, 1), stride=(stride, 1))

    def forward(self, x):
        lo, hi = same_padding(x.shape[2], self.kernel_size[0],
                              self.stride[0])
        return super().forward(F.pad(x, (0, 0, lo, hi)))


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int,
                 channels: Sequence[int] = (32, 128, 512, 1024),
                 use_weight_norm: bool = True):
        super().__init__()
        self.period = period
        self.n_convs = len(channels)
        in_ch = 1
        for i, ch in enumerate(channels):
            self.add_module(f"conv_{i}", _wn(SameConv2dTime(in_ch, ch, 5, 3),
                                             use_weight_norm))
            in_ch = ch
        self.conv_penult = _wn(SameConv2dTime(in_ch, 1024, 5),
                               use_weight_norm)
        self.conv_out = _wn(SameConv2dTime(1024, 1, 3), use_weight_norm)

    def forward(self, audio):
        b, n = audio.shape
        pad = (-n) % self.period
        x = F.pad(audio[:, None], (0, pad), mode="reflect") if pad \
            else audio[:, None]
        x = x.view(b, 1, -1, self.period)
        fmaps = []
        for i in range(self.n_convs):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = F.leaky_relu(self.conv_penult(x), LRELU_SLOPE)
        fmaps.append(x)
        x = self.conv_out(x)
        fmaps.append(x)
        return x.reshape(b, -1), fmaps


class MultiPeriodDiscriminator(nn.Module):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 use_weight_norm: bool = True):
        super().__init__()
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"period_{p}", PeriodDiscriminator(
                p, use_weight_norm=use_weight_norm))

    def forward(self, audio):
        return [getattr(self, f"period_{p}")(audio) for p in self.periods]


class ScaleDiscriminator(nn.Module):
    def __init__(self, use_weight_norm: bool = True):
        super().__init__()
        in_ch = 1
        for i, (ch, k, s, g) in enumerate(MSD_LAYERS):
            self.add_module(f"conv_{i}", _wn(SameConv1d(
                in_ch, ch, k, stride=s, groups=g), use_weight_norm))
            in_ch = ch
        self.conv_out = _wn(SameConv1d(in_ch, 1, 3), use_weight_norm)

    def forward(self, audio):
        x = audio[:, None]
        fmaps = []
        for i in range(len(MSD_LAYERS)):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), LRELU_SLOPE)
            fmaps.append(x)
        x = self.conv_out(x)
        fmaps.append(x)
        return x[:, 0], fmaps


def avg_pool_same(audio: torch.Tensor, k: int = 4, s: int = 2):
    """flax ``avg_pool(window k, stride s, padding "SAME")`` over (B, N):
    zero padding counted in the mean."""
    lo, hi = same_padding(audio.shape[-1], k, s)
    return F.avg_pool1d(F.pad(audio[:, None], (lo, hi)), k, s)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, num_scales: int = 3, use_weight_norm: bool = True):
        super().__init__()
        self.num_scales = num_scales
        for i in range(num_scales):
            self.add_module(f"scale_{i}", ScaleDiscriminator(
                use_weight_norm=use_weight_norm))

    def forward(self, audio):
        outs = []
        x = audio
        for i in range(self.num_scales):
            if i > 0:
                x = avg_pool_same(x)
            outs.append(getattr(self, f"scale_{i}")(x))
        return outs


class VocoderDiscriminator(nn.Module):
    """MPD + MSD under one module (one optimizer); fp32."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 num_scales: int = 3, use_weight_norm: bool = True):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(periods, use_weight_norm)
        self.msd = MultiScaleDiscriminator(num_scales, use_weight_norm)

    def forward(self, audio):
        return self.mpd(audio) + self.msd(audio)
