"""Variance adaptor: duration, pitch and energy prediction plus length
regulation (the port of transformer_tts_tpu/models/variance_adaptor.py:
36-217).

* ``VariancePredictor``: (Conv1d(k=3) -> ReLU -> LayerNorm -> dropout) x 2
  -> Linear -> one value per position, 0 where the mask is False.
* Durations are the targets when given, else
  ``clamp(round(exp(logd) - log_offset), 0)`` with an optional scale, and
  0 on padded phones.
* Pitch bins are ``exp(linspace(log f0_min, log f0_max, nbins-1))`` and
  energy bins ``linspace(energy_min, energy_max, nbins-1)``, in fp32;
  ``torch.bucketize(right=False)`` equals ``jnp.searchsorted``'s default
  side left.
* Scheduled sampling (train mode, ``p_scheduled_sampling`` > 0): per
  utterance, with probability p, the pitch embedding reads the
  prediction instead of the target; the draws come from the caller's
  ``generator`` (a CPU generator), as ``uniform(B, 1) < p``.
* ``Aligner``: the JAX package's working version of the reference's
  differentiable duration sketch (no model builds it): 3 x (Conv1d(k=9)
  SAME -> LayerNorm -> dropout) -> Linear to ``max_duration`` logits,
  Gaussian noise added in train mode (from the caller's generator), a
  sigmoid.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.models.sq_vae import device_generator
from transformer_tts_tpu_torch.ops.feedforward import Conv1dBTC, LN_EPS
from transformer_tts_tpu_torch.ops.length_regulator import (
    durations_from_log, length_regulate)
from transformer_tts_tpu_torch.ops.positional import PositionalEncoder

POS_DROPOUT = 0.1


class UniLSTM(nn.Module):
    """flax's ``OptimizedLSTMCell`` scanned over time from a zero carry, as
    ``nn.RNN`` scans it: the gates i, f, g, o (input, forget, cell,
    output) along dim 0 of ``weight_ih_l0`` (4H, in) and ``weight_hh_l0``
    (4H, H), torch's ``nn.LSTM`` layout and names. flax's input kernels
    have no bias and its hidden ones do: ``bias_hh_l0`` holds the hidden
    biases and the input bias is a zero buffer, outside the
    ``state_dict`` and the gradient. Runs in fp32 (autocast off), cuDNN's
    LSTM on the card."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_hh_l0 = nn.Parameter(torch.zeros(4 * hidden))
        self.register_buffer("bias_ih_l0", torch.zeros(4 * hidden),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, H) fp32, the hidden state after each
        frame."""
        with torch.autocast(x.device.type, enabled=False):
            h0 = x.new_zeros((1, x.shape[0], self.hidden),
                             dtype=torch.float32)
            out, _, _ = torch.lstm(
                x.float(), (h0, h0),
                (self.weight_ih_l0, self.weight_hh_l0, self.bias_ih_l0,
                 self.bias_hh_l0), True, 1, 0.0, self.training, False, True)
        return out


class VariancePredictor(nn.Module):
    def __init__(self, in_dim: int, filter_size: int = 256,
                 kernel_size: int = 3, dropout: float = 0.5):
        super().__init__()
        self.conv1 = Conv1dBTC(in_dim, filter_size, kernel_size)
        self.layer_norm1 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.conv2 = Conv1dBTC(filter_size, filter_size, kernel_size)
        self.layer_norm2 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.linear_layer = nn.Linear(filter_size, 1)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, mask=None):
        """``x`` (B, T, C); ``mask`` (B, 1, T) bool -> (B, T)."""
        h = self.dropout(self.layer_norm1(torch.relu(self.conv1(x))))
        h = self.dropout(self.layer_norm2(torch.relu(self.conv2(h))))
        out = self.linear_layer(h)[..., 0]
        if mask is not None:
            out = torch.where(mask[:, 0, :], out, torch.zeros_like(out))
        return out


class VarianceAdaptorOutput(NamedTuple):
    x: torch.Tensor                      # (B, T_mel, D) + pitch/energy emb
    log_duration: torch.Tensor           # (B, L)
    pitch: Optional[torch.Tensor]        # (B, T_mel)
    energy: Optional[torch.Tensor]       # (B, T_mel)
    mel_len: torch.Tensor                # (B,)
    mel_pos: torch.Tensor                # (B, T_mel) 1-based, 0 = pad
    mel_mask: torch.Tensor               # (B, 1, T_mel)
    text_dur_predicted: torch.Tensor     # expanded features pre-pitch/energy


def pitch_bins(f0_min: float, f0_max: float, n_bins: int) -> torch.Tensor:
    return torch.exp(torch.linspace(math.log(f0_min), math.log(f0_max),
                                    n_bins - 1, dtype=torch.float32))


def energy_bins(energy_min: float, energy_max: float,
                n_bins: int) -> torch.Tensor:
    return torch.linspace(energy_min, energy_max, n_bins - 1,
                          dtype=torch.float32)


class VarianceAdaptor(nn.Module):
    def __init__(self, d_model: int, n_bins: int = 256, f0_min: float = 71.0,
                 f0_max: float = 795.8, energy_min: float = 0.0,
                 energy_max: float = 315.0, log_offset: float = 1.0,
                 pitch_pred: bool = True, energy_pred: bool = True,
                 dropout: float = 0.5, f0_stats: Optional[tuple] = None,
                 energy_stats: Optional[tuple] = None,
                 p_scheduled_sampling: float = 0.0, use_pos: bool = False,
                 use_rnn_length: bool = False):
        super().__init__()
        self.log_offset = log_offset
        self.pos = (PositionalEncoder(d_model, POS_DROPOUT) if use_pos
                    else None)
        self.rnn_length = (UniLSTM(d_model, d_model) if use_rnn_length
                           else None)
        self.p_scheduled_sampling = p_scheduled_sampling
        # optional (mean, std): the predictors then work in standardized
        # units and are de-standardized before the bucketized embeddings
        self.f0_stats = f0_stats
        self.energy_stats = energy_stats
        self.duration_predictor = VariancePredictor(d_model,
                                                    dropout=dropout)
        self.pitch_predictor = self.energy_predictor = None
        if pitch_pred:
            self.pitch_predictor = VariancePredictor(d_model,
                                                     dropout=dropout)
            self.pitch_embedding = nn.Embedding(n_bins, d_model)
            self.register_buffer("pitch_bins",
                                 pitch_bins(f0_min, f0_max, n_bins),
                                 persistent=False)
        if energy_pred:
            self.energy_predictor = VariancePredictor(d_model,
                                                      dropout=dropout)
            self.energy_embedding = nn.Embedding(n_bins, d_model)
            self.register_buffer("energy_bins",
                                 energy_bins(energy_min, energy_max, n_bins),
                                 persistent=False)

    @staticmethod
    def _destandardize(v, stats):
        if stats is None:
            return v
        mean, std = stats
        return v * std + mean

    def forward(self, x, src_mask, max_frames: int, duration_target=None,
                pitch_target=None, energy_target=None, mel_mask=None, *,
                pitch_scale: float = 1.0, duration_scale: float = 1.0,
                generator: Optional[torch.Generator] = None
                ) -> VarianceAdaptorOutput:
        log_d = self.duration_predictor(x, src_mask)
        if duration_target is not None:
            durations = duration_target.long()
        else:
            durations = durations_from_log(log_d.float(), self.log_offset,
                                           duration_scale)
            durations = torch.where(src_mask[:, 0, :], durations,
                                    torch.zeros_like(durations))

        x, mel_len, mel_pos = length_regulate(x, durations, max_frames)
        if mel_mask is None:
            mel_mask = (mel_pos != 0)[:, None, :]
        if self.pos is not None:
            x = self.pos(x)
        if self.rnn_length is not None:
            x = self.rnn_length(x)

        # both predictors read the expanded features without the
        # pitch/energy embeddings, which are added only at the end
        pitch = energy = None
        out = x
        if self.pitch_predictor is not None:
            pitch = self.pitch_predictor(x, mel_mask)
            pitch_raw = self._destandardize(pitch, self.f0_stats)
            if pitch_target is not None:
                src = pitch_target
                p = self.p_scheduled_sampling
                if self.training and p > 0.0:
                    swap = torch.rand((x.shape[0], 1),
                                      generator=generator) < p
                    if x.device.type == "cuda":   # copy without a wait
                        swap = swap.pin_memory()
                    src = torch.where(swap.to(x.device, non_blocking=True),
                                      pitch_raw, src)
            else:
                src = pitch_raw * pitch_scale
            idx = torch.bucketize(src.float(), self.pitch_bins)
            out = out + self.pitch_embedding(idx)
        if self.energy_predictor is not None:
            energy = self.energy_predictor(x, mel_mask)
            src = (energy_target if energy_target is not None
                   else self._destandardize(energy, self.energy_stats))
            idx = torch.bucketize(src.float(), self.energy_bins)
            out = out + self.energy_embedding(idx)
        return VarianceAdaptorOutput(
            x=out, log_duration=log_d, pitch=pitch, energy=energy,
            mel_len=mel_len, mel_pos=mel_pos, mel_mask=mel_mask,
            text_dur_predicted=x)


class Aligner(nn.Module):
    def __init__(self, d_model: int, max_duration: int,
                 kernel_size: int = 9, dropout: float = 0.1):
        super().__init__()
        self.convs = nn.ModuleList(Conv1dBTC(d_model, d_model, kernel_size)
                                   for _ in range(3))
        self.norms = nn.ModuleList(nn.LayerNorm(d_model, eps=LN_EPS)
                                   for _ in range(3))
        self.out = nn.Linear(d_model, max_duration)
        self.dropout = nn.Dropout(dropout)

    def forward(self, encoded: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L, d) -> (B, L, max_duration) in (0, 1); in train mode the
        logits get N(0, 1) noise drawn from ``generator``."""
        x = encoded
        for conv, norm in zip(self.convs, self.norms):
            x = self.dropout(norm(conv(x)))
        out = self.out(x)
        if self.training:
            out = out + torch.randn(
                out.shape, device=out.device,
                generator=device_generator(generator, out.device)
            ).to(out.dtype)
        return torch.sigmoid(out)
