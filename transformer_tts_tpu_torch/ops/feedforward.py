"""Convolutions on (B, T, C) and the feed-forward blocks (the port of
transformer_tts_tpu/ops/feedforward.py:27-95).

``ConvFeedForward`` keeps the reference's ordering: Conv1d(d -> 4d), ReLU,
Conv1d(4d -> d), the residual added inside the module, then dropout, then
LayerNorm. ``EncoderLayer`` adds a second residual around it.

The conformer's blocks: ``ConformerFeedForward`` (LN, Linear(d -> 2d),
Swish, dropout, Linear, dropout) and ``ConformerConvModule`` (LN,
pointwise conv d -> 2d and GLU, depthwise conv k=31 and its extra 1x1,
BatchNorm, ReLU, pointwise conv, dropout). BatchNorm follows flax: eps
1e-5, momentum 0.99 (torch ``momentum=0.01``); in train mode it normalises
with the batch's statistics over every frame, padded ones included, and
moves the running variance towards the *biased* batch variance, as flax
does (torch's own BatchNorm moves it towards the unbiased one).

Under data parallelism (``parallel/mesh.data_parallel`` sets each norm's
``stats_group``) the per-channel sums of x and x^2 and the count are
all-reduced in fp32 through a differentiable collective, so every rank
normalises with the global batch's mean and biased variance and moves its
running statistics by the same values: what pjit gives flax over the
logical global batch. ``nn.SyncBatchNorm`` is not used: its running
variance moves towards the unbiased variance, and it refuses CPU tensors.
``frozen_statistics`` keeps the running statistics still (a remat
recompute runs the forward a second time).

Under tensor parallelism (parallel/tp.py sets ``tp``) a feed-forward block
holds a slice of its hidden channels: its first product is column-split
(``tp.column``), its second row-split (``tp.row``: the partial products
summed over the group before the bias is added), and the conformer
block's hidden dropout keeps the slice of the whole mask. Under autocast
on the card a convolution's bias is added to its rounded product, as
cuDNN's convolution adds it (``Conv1dBTC.bias_apart``); on the CPU
oneDNN's convolution and every GEMM add it before the one rounding.
"""

from __future__ import annotations

import warnings
from contextlib import contextmanager
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


def differentiable_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; its backward sums
    the ranks' gradients the same way."""
    from torch.distributed.nn.functional import all_reduce
    with warnings.catch_warnings():
        # deprecated in newer torch for _functional_collectives, whose
        # autograd older versions lack
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(x, group=group)


def _flax_train_norm(bn: nn.modules.batchnorm._BatchNorm,
                     x: torch.Tensor) -> torch.Tensor:
    """flax's train-mode BatchNorm on (B, C, ...): mean and variance in
    fp32 over every axis but C (and over the ranks of ``bn.stats_group``),
    the variance as max(0, E[x^2] - E[x]^2) (flax's fast variance,
    biased), and the running statistics moved by ``momentum`` towards
    those values unless ``bn.frozen``."""
    dims = (0,) + tuple(range(2, x.dim()))
    shape = (-1,) + (1,) * (x.dim() - 2)
    xf = x.float()
    group = getattr(bn, "stats_group", None)
    if group is None:
        mean = xf.mean(dim=dims)
        var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
    else:
        count = torch.full((1,), float(xf.numel() // xf.shape[1]),
                           device=xf.device)
        sums = differentiable_all_reduce(
            torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
            group)
        c = xf.shape[1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    if not getattr(bn, "frozen", False):
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * var)
            bn.num_batches_tracked.add_(1)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (xf - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return y.to(x.dtype)


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` on (B, C, T) with flax's train-mode statistics
    (``_flax_train_norm``, over (B, T)). Eval mode is torch's, with the
    running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_train_norm(self, x)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` on (B, C, H, W) with flax's train-mode
    statistics (``_flax_train_norm``, over (B, H, W)); eval mode is
    torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        return _flax_train_norm(self, x)


FLAX_NORMS = (FlaxBatchNorm1d, FlaxBatchNorm2d)


@contextmanager
def frozen_statistics(model: nn.Module):
    """The running statistics of ``model``'s flax-style BatchNorms stay
    still inside the block."""
    norms = [m for m in model.modules() if isinstance(m, FLAX_NORMS)]
    for m in norms:
        m.frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.frozen = False


def batch_norm(channels: int) -> nn.BatchNorm1d:
    """BatchNorm1d with flax's defaults and train-mode statistics."""
    return FlaxBatchNorm1d(channels, eps=1e-5, momentum=0.01)


class Conv1dBTC(nn.Conv1d):
    """``nn.Conv1d`` on (B, T, C) tensors with flax's padding: "SAME"
    ((k-1)//2 left, k//2 right) or an explicit (left, right) pair."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int,
                 padding: Union[str, Tuple[int, int]] = "SAME"):
        if padding == "SAME":
            padding = ((kernel_size - 1) // 2, kernel_size // 2)
        left, right = padding
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=left if left == right else 0)
        self.pad = None if left == right else (left, right)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight, self.bias)

    def conv(self, x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
        """This layer's convolution of ``x`` with the given ``weight`` and
        ``bias`` (a tensor-parallel rank's slices)."""
        x = x.transpose(1, 2)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return self._conv_forward(x, weight, bias).transpose(1, 2)

    @staticmethod
    def bias_apart(x: torch.Tensor) -> bool:
        """Whether torch's convolution of ``x`` under autocast adds the bias
        to the rounded product (cuDNN's, on the card) rather than before
        its one rounding (oneDNN's, on the CPU): a tensor-parallel rank's
        split product rounds as this layer does."""
        return x.is_cuda


class ConvFeedForward(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 5,
                 dropout: float = 0.1):
        super().__init__()
        self.f_1 = Conv1dBTC(d_model, d_model * 4, kernel_size)
        self.f_2 = Conv1dBTC(d_model * 4, d_model, kernel_size)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.tp = None          # parallel/tp.py, once the channels are split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.dropout(self.inner(x) + x))

    def inner(self, x: torch.Tensor) -> torch.Tensor:
        """The two convolutions, without the residual and the norm."""
        tp = self.tp
        if tp is None:
            return self.f_2(torch.relu(self.f_1(x)))
        apart = self.f_1.bias_apart(x)
        h, = tp.column(self.f_1.conv, [(x, self.f_1.weight, self.f_1.bias)],
                       bias_apart=apart)
        return tp.row(self.f_2.conv, torch.relu(h), self.f_2.weight,
                      self.f_2.bias, bias_apart=apart)


class ConformerFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.1):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)
        self.dropout = nn.Dropout(dropout)
        self.tp = None          # parallel/tp.py, once the channels are split

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layer_norm(x)
        if self.tp is None:
            x = self.linear1(x)
            x = self.dropout(x * torch.sigmoid(x))
            return self.dropout(self.linear2(x))
        tp = self.tp
        x, = tp.column(F.linear, [(x, self.linear1.weight,
                                   self.linear1.bias)])
        x = tp.dropout(self.dropout, x * torch.sigmoid(x), -1)
        return self.dropout(tp.row(F.linear, x, self.linear2.weight,
                                   self.linear2.bias))


class DepthwiseConv(nn.Module):
    """Depthwise conv ("SAME" padding for an odd kernel) and the extra
    1x1 conv after it, on (B, C, T)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size,
                              padding=(kernel_size - 1) // 2,
                              groups=channels)
        self.conv_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.conv(x))


class ConformerConvModule(nn.Module):
    def __init__(self, d_model: int, kernel_size: int = 31,
                 dropout: float = 0.1):
        super().__init__()
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.pointwise_conv1 = nn.Conv1d(d_model, 2 * d_model, 1)
        self.depth_conv1 = DepthwiseConv(d_model, kernel_size)
        self.batch_norm = batch_norm(d_model)
        self.pointwise_conv2 = nn.Conv1d(d_model, d_model, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d_model) -> (B, T, d_model)."""
        x = self.pointwise_conv1(self.layer_norm(x).transpose(1, 2))
        out, gate = x.chunk(2, dim=1)
        x = self.depth_conv1(out * torch.sigmoid(gate))
        x = self.pointwise_conv2(torch.relu(self.batch_norm(x)))
        return self.dropout(x.transpose(1, 2))
