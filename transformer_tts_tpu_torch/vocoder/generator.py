"""HiFi-GAN and iSTFT vocoders (the port of
transformer_tts_tpu/vocoder/generator.py: ``ResBlock1``,
``HiFiGANGenerator``, ``ConvNeXtBlock``, ``ISTFTVocoder``, :35-211).

Both take a mel (B, T, mel_dim) and give a waveform (B, T * hop) in fp32,
as the JAX modules do; inside, the HiFi-GAN generator runs in NCL. Module
names are the flax ones (``conv_pre``, ``up_<i>``, ``res_<i>_<j>.conv1_<k>``,
``conv_post``; ``embed``, ``block_<i>.dwconv``, ``head``), so that
``compat/from_jax.vocoder_state_dict_from_flax`` carries the JAX package's
weights over by name.

* Convolutions pad as flax's ``"SAME"`` does (``same_padding``): for
  stride 1 and an odd kernel that is symmetric; ``F.pad`` applies it in
  general, since flax puts the odd sample on the right.
* Weight norm is ``torch.nn.utils.parametrizations.weight_norm``: ``g``
  (``original0``) per output channel, ``v`` (``original1``). flax's
  ``WeightNorm`` normalizes per output feature too, with its scale
  initialised to 1, as ``init_vocoder_parameters`` does.
* Subpixel upsampling: a stride-1 conv to r * ch channels, then channel
  j * ch + c becomes sample j of feature c (flax's NLC reshape).
* Transposed upsampling is flax's ``ConvTranspose(padding="SAME")``, i.e.
  ``lax.conv_transpose`` without a kernel flip: its input-dilated
  correlation pads (pad_a, pad_b) with pad_a = k - 1 when s > k - 1, else
  ceil((k + s - 2) / 2), and gives T * s samples. ``ConvTranspose1d`` with
  ``padding = k - 1 - pad_a`` and the kernel flipped along k computes it.

``amp`` runs the generator's convolutions under bf16 autocast (the JAX
package's ``dtype=bfloat16`` with fp32 parameters); the waveform is fp32
either way, and the iSTFT vocoder's head and overlap-add run in fp32.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils.parametrizations import weight_norm

from transformer_tts_tpu_torch.ops.melspectrogram import hann_window, istft

LRELU_SLOPE = 0.1
LN_EPS = 1e-6                 # flax LayerNorm's epsilon


def same_padding(n: int, k: int, s: int = 1, d: int = 1) -> Tuple[int, int]:
    """flax/lax ``"SAME"``: out = ceil(n / s); the input is padded by
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0), total // 2 on the
    left and the rest on the right."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def conv_transpose_same_padding(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s ``"SAME"`` pads of the dilated input."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return pad_a, pad_len - pad_a


class SameConv1d(nn.Conv1d):
    """Conv1d with flax's ``"SAME"`` padding (``same_padding``)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 dilation: int = 1, groups: int = 1):
        super().__init__(in_ch, out_ch, k, stride=stride, dilation=dilation,
                         groups=groups)

    def forward(self, x):
        lo, hi = same_padding(x.shape[-1], self.kernel_size[0],
                              self.stride[0], self.dilation[0])
        return super().forward(F.pad(x, (lo, hi)))


class SameConvTranspose1d(nn.ConvTranspose1d):
    """flax's ``ConvTranspose(padding="SAME")``: T -> T * stride; the
    weight is flax's kernel flipped along k, laid out (in, out, k)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int):
        pad_a, pad_b = conv_transpose_same_padding(k, stride)
        super().__init__(in_ch, out_ch, k, stride=stride,
                         padding=k - 1 - pad_a)
        self.crop = pad_a - pad_b       # samples past pad_b on the right

    def forward(self, x):
        y = super().forward(x)
        return y[..., :y.shape[-1] - self.crop] if self.crop else y


def _wn(conv: nn.Module, use_weight_norm: bool) -> nn.Module:
    if not use_weight_norm:
        return conv
    return weight_norm(conv, dim=1 if isinstance(conv, nn.ConvTranspose1d)
                       else 0)


class ResBlock1(nn.Module):
    """Per dilation: lrelu -> dilated conv -> lrelu -> conv, plus the
    residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Sequence[int] = (1, 3, 5),
                 use_weight_norm: bool = True):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            self.add_module(f"conv1_{i}", _wn(SameConv1d(
                channels, channels, kernel_size, dilation=d),
                use_weight_norm))
            self.add_module(f"conv2_{i}", _wn(SameConv1d(
                channels, channels, kernel_size), use_weight_norm))

    def forward(self, x):
        for i in range(len(self.dilations)):
            h = getattr(self, f"conv1_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            h = getattr(self, f"conv2_{i}")(F.leaky_relu(h, LRELU_SLOPE))
            x = x + h
        return x


class HiFiGANGenerator(nn.Module):
    """mel (B, T, mel_dim) -> waveform (B, T * prod(upsample_rates)).
    The defaults are HiFi-GAN V1 for 22.05 kHz / hop 256 audio."""

    def __init__(self, mel_dim: int = 80,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 upsample_initial_channel: int = 512,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilations: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_mode: str = "subpixel",
                 subpixel_kernel_size: int = 3,
                 use_weight_norm: bool = True, amp: bool = False):
        super().__init__()
        if upsample_mode not in ("subpixel", "transposed"):
            raise ValueError(f"bad upsample_mode {upsample_mode!r}")
        self.mel_dim = mel_dim
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_mode = upsample_mode
        self.subpixel_kernel_size = subpixel_kernel_size
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.n_res = len(resblock_kernel_sizes)
        self.amp = amp
        self.conv_pre = _wn(SameConv1d(mel_dim, upsample_initial_channel, 7),
                            use_weight_norm)
        in_ch = upsample_initial_channel
        for i, (r, k) in enumerate(zip(self.upsample_rates,
                                       upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            if upsample_mode == "subpixel":
                up = SameConv1d(in_ch, ch * r, subpixel_kernel_size)
            else:
                up = SameConvTranspose1d(in_ch, ch, k, r)
            self.add_module(f"up_{i}", _wn(up, use_weight_norm))
            for j, (rk, rd) in enumerate(zip(resblock_kernel_sizes,
                                             resblock_dilations)):
                self.add_module(f"res_{i}_{j}", ResBlock1(
                    ch, rk, rd, use_weight_norm=use_weight_norm))
            in_ch = ch
        self.conv_post = _wn(SameConv1d(in_ch, 1, 7), use_weight_norm)

    @property
    def hop_length(self) -> int:
        return math.prod(self.upsample_rates)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        with torch.autocast(mel.device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            x = self.conv_pre(mel.transpose(1, 2))
            for i, r in enumerate(self.upsample_rates):
                x = getattr(self, f"up_{i}")(F.leaky_relu(x, LRELU_SLOPE))
                if self.upsample_mode == "subpixel":
                    b, _, t = x.shape
                    x = x.view(b, r, -1, t).permute(0, 2, 3, 1).reshape(
                        b, -1, t * r)
                acc = None
                for j in range(self.n_res):
                    h = getattr(self, f"res_{i}_{j}")(x)
                    acc = h if acc is None else acc + h
                x = acc / self.n_res
            x = self.conv_post(F.leaky_relu(x, LRELU_SLOPE))
        return torch.tanh(x.float())[:, 0]


class ConvNeXtBlock(nn.Module):
    """depthwise conv (k) -> LayerNorm -> pointwise MLP (tanh GELU, flax's
    default), layer-scaled residual; (B, T, C) in and out."""

    def __init__(self, channels: int, mlp_dim: int, kernel_size: int = 7,
                 layer_scale_init: float = 1e-6):
        super().__init__()
        self.dwconv = SameConv1d(channels, channels, kernel_size,
                                 groups=channels)
        self.norm = nn.LayerNorm(channels, eps=LN_EPS)
        self.pw1 = nn.Linear(channels, mlp_dim)
        self.pw2 = nn.Linear(mlp_dim, channels)
        self.gamma = nn.Parameter(torch.full((channels,), layer_scale_init))

    def forward(self, x):
        h = self.dwconv(x.transpose(1, 2)).transpose(1, 2)
        h = self.pw2(F.gelu(self.pw1(self.norm(h)), approximate="tanh"))
        return x + self.gamma.to(h.dtype) * h


class ISTFTVocoder(nn.Module):
    """mel (B, T, mel_dim) -> waveform (B, T * hop_length): a ConvNeXt
    backbone at frame rate and a head predicting each frame's
    log-magnitude (clipped to [-100, 7]) and phase, then one inverse FFT
    and the windowed overlap-add of ops/melspectrogram.istft."""

    def __init__(self, mel_dim: int = 80, channels: int = 512,
                 mlp_dim: int = 1536, num_layers: int = 8,
                 kernel_size: int = 7, n_fft: int = 1024,
                 hop_length: int = 256, amp: bool = False):
        super().__init__()
        self.mel_dim = mel_dim
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.num_layers = num_layers
        self.kernel_size = kernel_size
        self.amp = amp
        self.embed = SameConv1d(mel_dim, channels, kernel_size)
        self.norm_pre = nn.LayerNorm(channels, eps=LN_EPS)
        for i in range(num_layers):
            self.add_module(f"block_{i}", ConvNeXtBlock(
                channels, mlp_dim, kernel_size))
        self.norm_post = nn.LayerNorm(channels, eps=LN_EPS)
        self.head = nn.Linear(channels, n_fft + 2)

    @property
    def receptive_field_radius_frames(self) -> int:
        """Frames on each side that reach an output sample: the embed conv
        and one depthwise conv per block at frame rate, plus the
        overlap-add's span (the JAX generator's, :181-187); what
        infer/streaming.StreamingVocoder overlaps its windows by."""
        return ((self.kernel_size // 2) * (self.num_layers + 1)
                + self.n_fft // self.hop_length)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        device = mel.device
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=self.amp):
            x = self.embed(mel.transpose(1, 2)).transpose(1, 2)
            x = self.norm_pre(x)
            for i in range(self.num_layers):
                x = getattr(self, f"block_{i}")(x)
            x = self.norm_post(x)
        # the head and the overlap-add in fp32: phase wrap and the
        # window-sum normalisation are the delicate part
        with torch.autocast(device.type, enabled=False):
            h = self.head(x.float())
            n_bins = self.n_fft // 2 + 1
            logmag = torch.clamp(h[..., :n_bins], -1e2, 7.0)
            spec = torch.polar(torch.exp(logmag), h[..., n_bins:])
            window = hann_window(self.n_fft, self.n_fft, device)
            return istft(spec, self.n_fft, self.hop_length, window,
                         mel.shape[1] * self.hop_length)


@torch.no_grad()
def init_vocoder_parameters(model: nn.Module,
                            generator: torch.Generator) -> None:
    """Random weights from ``generator``: conv and Linear weights (weight
    norm's ``v``) uniform in +-1/sqrt(fan_in), weight norm's ``g`` 1 (flax's
    scale init), biases 0, LayerNorm scales 1; ``gamma`` keeps its layer
    scale."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d,
                               nn.ConvTranspose1d)):
            wn = getattr(module, "parametrizations", None)
            w = wn.weight.original1 if wn is not None else module.weight
            fan_in = (w.shape[0] * w.shape[2]       # (in, out, k)
                      if isinstance(module, nn.ConvTranspose1d)
                      else w[0].numel())
            bound = 1.0 / math.sqrt(fan_in)
            w.copy_(torch.rand(w.shape, generator=generator) * 2 * bound
                    - bound)
            if wn is not None:
                wn.weight.original0.fill_(1.0)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
