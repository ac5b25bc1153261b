"""FastSpeech 2 losses (the port of transformer_tts_tpu/train/losses.py:
``l1`` :24-31, ``channel_wise_l1`` :34-40, ``duration_loss`` :43-48 and
``fastspeech2_loss`` :132-261 with the flagship's options).

L1 on mel_pre and mel_post, L1 of the predicted log durations against
log(d + log_offset), and L1 on f0 and energy, all in fp32. ``masked=False``
(the default, the reference's plain ``nn.L1Loss``) averages over padded
frames too; ``f0_stats``/``energy_stats`` standardise those targets and
average them over valid frames. The SSIM loss, the discrete
(``output_type='softmax'``) mode and the SQ-VAE come with the other model
families.
"""

from __future__ import annotations

from typing import Optional

import torch

from transformer_tts_tpu_torch.models.fastspeech2 import later_slice


def l1(pred: torch.Tensor, target: torch.Tensor,
       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute error in fp32; ``mask`` (bool, True = count)
    broadcasts to the error's shape."""
    err = (pred.float() - target.float()).abs()
    if mask is None:
        return err.mean()
    mask = mask.expand(err.shape).float()
    return (err * mask).sum() / mask.sum().clamp(min=1.0)


def channel_wise_l1(pred: torch.Tensor, target: torch.Tensor,
                    channel_weight, split: int = 20) -> torch.Tensor:
    """Weighted L1 over the channels [0, split) and [split, ...)."""
    w0, w1 = channel_weight
    return (w0 * l1(pred[:, :, :split], target[:, :, :split])
            + w1 * l1(pred[:, :, split:], target[:, :, split:]))


def duration_loss(log_d_pred: torch.Tensor, d_target: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  log_offset: float = 1.0) -> torch.Tensor:
    """L1(log_d_pred, log(d_target + log_offset))."""
    return l1(log_d_pred, torch.log(d_target.float() + log_offset), mask)


def _standardise(values, stats, mel_mask, vmask):
    """(values in standard units, 0 on padded frames; their mask)."""
    if values is None or stats is None:
        return values, vmask
    values = (values - stats[0]) / stats[1]
    if mel_mask is None:
        return values, vmask
    vmask = mel_mask[:, 0, :]
    return torch.where(vmask, values, torch.zeros_like(values)), vmask


def fastspeech2_loss(out, mel: torch.Tensor, d_target: torch.Tensor,
                     f0: Optional[torch.Tensor],
                     energy: Optional[torch.Tensor], *,
                     src_mask: Optional[torch.Tensor] = None,
                     mel_mask: Optional[torch.Tensor] = None,
                     masked: bool = False, use_ssim: bool = False,
                     use_sq_vae: bool = False, log_offset: float = 1.0,
                     channel_wise: bool = False, channel_weight=None,
                     output_type=None, f0_stats=None, energy_stats=None):
    """(total, logs) for a ``FastSpeech2Output``; the logs carry the JAX
    package's keys: loss_frame_before, loss_frame_after, loss_duration,
    loss_f0, loss_energy and loss_total."""
    if use_ssim:
        later_slice("the SSIM loss (use_ssim)", "other model families")
    if output_type == "softmax":
        later_slice("the discrete output mode (output_type='softmax')",
                    "other model families")
    if use_sq_vae:
        later_slice("the SQ-VAE loss (use_sq_vae)", "other model families")
    use_mask = masked and mel_mask is not None
    fmask = mel_mask[:, 0, :, None] if use_mask else None
    vmask = mel_mask[:, 0, :] if use_mask else None
    smask = src_mask[:, 0, :] if (masked and src_mask is not None) else None
    f0, f0_vmask = _standardise(f0, f0_stats, mel_mask, vmask)
    energy, energy_vmask = _standardise(energy, energy_stats, mel_mask,
                                        vmask)

    def mel_l1(pred):
        if channel_wise:
            cw = channel_weight if channel_weight is not None else (1.0, 1.0)
            return channel_wise_l1(pred, mel, cw)
        return l1(pred, mel, fmask)

    logs = {"loss_frame_before": mel_l1(out.mel_pre)}
    total = logs["loss_frame_before"]
    if out.mel_post is not None:
        logs["loss_frame_after"] = mel_l1(out.mel_post)
        total = total + logs["loss_frame_after"]
    logs["loss_duration"] = duration_loss(out.log_duration, d_target, smask,
                                          log_offset)
    total = total + logs["loss_duration"]
    if out.pitch is not None and f0 is not None:
        logs["loss_f0"] = l1(out.pitch, f0, f0_vmask)
        total = total + logs["loss_f0"]
    if out.energy is not None and energy is not None:
        logs["loss_energy"] = l1(out.energy, energy, energy_vmask)
        total = total + logs["loss_energy"]
    logs["loss_total"] = total
    return total, logs
