"""FastSpeech 2 and AR Transformer-TTS losses (the port of
transformer_tts_tpu/train/losses.py: ``l1`` :24-31, ``channel_wise_l1``
:34-40, ``duration_loss`` :43-48, ``stop_token_loss`` :51-68,
``ctc_aux_loss`` :71-86, ``mse_loss_arelbo`` :89-93, ``ssim`` :96-129,
``fastspeech2_loss`` :132-261 with the flagship's options, SSIM, the
SQ-VAE's and the discrete mode, ``transformer_tts_loss`` :264-281 and
``softmax_output_loss`` :312-343), and the integrate trainer's
``time_weighted_l1`` :284-298 and ``cosine_embedding_loss`` :301-309).

L1 on mel_pre and mel_post, L1 of the predicted log durations against
log(d + log_offset), and L1 on f0 and energy, all in fp32. ``masked=False``
(the default, the reference's plain ``nn.L1Loss``) averages over padded
frames too; ``f0_stats``/``energy_stats`` standardise those targets and
average them over valid frames. ``use_sq_vae`` takes the AR-ELBO MSE for
mel_pre and adds the output's ``sq_vae_loss`` (logging it and the
perplexity). ``use_ssim`` adds -SSIM of mel_post against the mel
(``loss_ssim``). The discrete mode (``output_type='softmax'``) reads the
(B, T, 2*C) output as two streams of C-class logits against (B, T, 2)
int codes: cross-entropy per stream in fp32 over the codes that are not
the pad 320, the two summed, for mel_pre and mel_post, with
``accuracy_1``/``accuracy_2`` of mel_post in the logs; the duration, f0
and energy losses still apply. The AR loss is L1 on the pre and
post mel and the stop token's BCE with a positive-class weight, in the
stable ``logaddexp`` form.

Data parallelism: a plain mean over a rank's fixed-shape batch averages
under DDP to the global batch's mean, but a mean over valid elements does
not when the ranks hold different numbers of them. Inside
``global_means(group)`` every mean over a mask (``l1`` and
``stop_token_loss`` with one, ``softmax_output_loss``'s valid codes,
``masked_mean``) divides the rank's sum by the group's count (all-reduced,
no gradient) over the group's size, so DDP's average of the ranks' losses
is the global batch's masked mean, as JAX computes it on the logical
global batch.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn.functional as F

from transformer_tts_tpu_torch.data.batching import CODE_PAD

_GROUP = []                  # the data-parallel group of global_means


@contextmanager
def global_means(group):
    """Masked means inside the block are the global batch's over the
    ranks of ``group`` (None: this process's)."""
    _GROUP.append(group)
    try:
        yield
    finally:
        _GROUP.pop()


def mean_count(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a masked mean of ``count`` (fp32) valid
    elements, at least 1: the group's count over its size inside
    ``global_means``."""
    count = count.float()
    if _GROUP and _GROUP[-1] is not None:
        import torch.distributed as dist
        group = _GROUP[-1]
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
        return count.clamp(min=1.0) / dist.get_world_size(group)
    return count.clamp(min=1.0)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / ``mean_count``(sum(mask)); ``mask`` broadcasts
    to ``values``."""
    mask = mask.expand(values.shape).float()
    return (values * mask).sum() / mean_count(mask.sum())


def l1(pred: torch.Tensor, target: torch.Tensor,
       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute error in fp32; ``mask`` (bool, True = count)
    broadcasts to the error's shape."""
    err = (pred.float() - target.float()).abs()
    if mask is None:
        return err.mean()
    return masked_mean(err, mask)


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


def ctc_aux_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor,
                 blank_id: int = 0) -> torch.Tensor:
    """The CTC auxiliary loss of (B, T, K) raw ``logits`` (log-softmax in
    fp32 inside, autocast off) against (B, L) ``labels``, each row valid
    over its first ``logit_lengths`` frames and ``label_lengths`` labels:
    each utterance's negative log-likelihood divided by its label length
    (at least 1), then the batch mean (``F.ctc_loss``'s
    ``reduction='mean'``, which is what the JAX package computes with
    optax). A row with fewer frames than its labels need has an infinite
    loss, in both packages (no ``zero_infinity``)."""
    with torch.autocast(logits.device.type, enabled=False):
        log_probs = F.log_softmax(logits.float(), dim=-1)
        return F.ctc_loss(log_probs.transpose(0, 1), labels.long(),
                          logit_lengths.long(), label_lengths.long(),
                          blank=blank_id, reduction="mean",
                          zero_infinity=False)


def time_weighted_l1(pred: torch.Tensor, target: torch.Tensor,
                     time_mask: torch.Tensor, time_weight,
                     mel_dim: int) -> torch.Tensor:
    """The semantic mask's time-weighted L1: ``time_weight[0]`` x the L1
    summed over the masked frames ((B, T, 1) bool ``time_mask``) / their
    count / ``mel_dim``, plus ``time_weight[1]`` x the same over the
    others, in fp32; the counts are ``mean_count``'s."""
    err = (pred.float() - target.float()).abs()
    m = time_mask.float()
    inv = 1.0 - m
    loss_mask = (err * m).sum() / mean_count(m.sum()) / mel_dim
    loss_unmask = (err * inv).sum() / mean_count(inv.sum()) / mel_dim
    return time_weight[0] * loss_mask + time_weight[1] * loss_unmask


def cosine_embedding_loss(x1: torch.Tensor, x2: torch.Tensor
                          ) -> torch.Tensor:
    """``F.cosine_embedding_loss`` with target +1: the mean over rows of
    1 - cos of the flattened rows, the norms' product held at 1e-8 or
    more, in fp32."""
    a = x1.reshape(x1.shape[0], -1).float()
    b = x2.reshape(x2.shape[0], -1).float()
    cos = (a * b).sum(-1) / (torch.linalg.vector_norm(a, dim=-1)
                             * torch.linalg.vector_norm(b, dim=-1)
                             ).clamp(min=1e-8)
    return (1.0 - cos).mean()


def gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(x: torch.Tensor, y: torch.Tensor, data_range=None,
         window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Gaussian-window SSIM (k1 0.01, k2 0.03) of (B, H, W) images, VALID
    windows, averaged, in fp32; ``data_range`` defaults to the larger of
    max - min of ``x`` and of ``y`` over the batch."""
    with torch.autocast(x.device.type, enabled=False):
        x, y = x.float(), y.float()
        if data_range is None:
            data_range = torch.maximum(x.max() - x.min(), y.max() - y.min())
        win = gaussian_window(window_size, sigma).to(x.device)
        kernel = torch.outer(win, win)[None, None]

        def filt(img):
            return F.conv2d(img[:, None], kernel)[:, 0]

        mu_x, mu_y = filt(x), filt(y)
        sxx = filt(x * x) - mu_x ** 2
        syy = filt(y * y) - mu_y ** 2
        sxy = filt(x * y) - mu_x * mu_y
        c1 = (0.01 * data_range) ** 2
        c2 = (0.03 * data_range) ** 2
        num = (2 * mu_x * mu_y + c1) * (2 * sxy + c2)
        den = (mu_x ** 2 + mu_y ** 2 + c1) * (sxx + syy + c2)
        return (num / den).mean()


def mse_loss_arelbo(pred: torch.Tensor,
                    target: torch.Tensor) -> torch.Tensor:
    """The AR-ELBO surrogate 0.5 * n * log(mean((pred - target)^2)), n the
    elements per batch row, in fp32."""
    n = target.numel() // target.shape[0]
    return 0.5 * n * torch.log(torch.mean(
        (pred.float() - target.float()) ** 2))


def stop_token_loss(logits: torch.Tensor, target: torch.Tensor,
                    pos_weight: float = 5.0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BCE-with-logits with weight ``pos_weight`` on the positive class,
    in fp32: pos_weight * z * -log(sigmoid(x)) + (1 - z) *
    -log(1 - sigmoid(x)), each term a ``logaddexp``. The target is 1.0 at
    stop frames and on padding."""
    x, z = logits.float(), target.float()
    zero = torch.zeros((), device=x.device)
    per = (pos_weight * z * torch.logaddexp(zero, -x)
           + (1.0 - z) * torch.logaddexp(zero, x))
    if mask is None:
        return per.mean()
    return masked_mean(per, mask)


def transformer_tts_loss(mel_pre: torch.Tensor, mel_post: torch.Tensor,
                         stop_logits: torch.Tensor, mel_target: torch.Tensor,
                         stop_target: torch.Tensor, *,
                         positive_weight: float = 5.0,
                         mask: Optional[torch.Tensor] = None):
    """(total, logs): L1(pre) + L1(post) + the weighted stop BCE, under the
    JAX package's keys loss_frame_before, loss_frame_after, loss_token and
    loss_total."""
    fmask = mask[..., None] if mask is not None else None
    pre = l1(mel_pre, mel_target, fmask)
    post = l1(mel_post, mel_target, fmask)
    stop = stop_token_loss(stop_logits, stop_target, positive_weight, mask)
    total = pre + post + stop
    return total, {"loss_frame_before": pre, "loss_frame_after": post,
                   "loss_token": stop, "loss_total": total}


def softmax_output_loss(pred: torch.Tensor, targets: torch.Tensor,
                        num_classes: int, ignore_index: int = CODE_PAD):
    """(loss, {accuracy_1, accuracy_2}) of (B, T, 2*num_classes) logits,
    the first and second half one stream each, against (B, T, 2) int
    codes: each stream's mean fp32 cross-entropy over its codes that are
    not ``ignore_index`` (at least 1 counted), the two summed; the
    accuracies of the argmax over the same codes."""
    logs = {}
    total = 0.0
    for k in range(2):
        logits = pred[:, :, k * num_classes:(k + 1) * num_classes].float()
        t = targets[:, :, k].long()
        valid = t != ignore_index
        n = mean_count(valid.sum())
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, torch.where(valid, t, 0)[..., None])
        total = total + torch.where(valid, nll[..., 0], 0.0).sum() / n
        logs[f"accuracy_{k + 1}"] = (
            (valid & (logits.argmax(-1) == t)).sum() / n)
    return total, logs


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
    loss_f0, loss_energy, loss_ssim and loss_total (and accuracy_1,
    accuracy_2 in the discrete mode)."""
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

    if output_type == "softmax":
        num_classes = out.mel_pre.shape[-1] // 2
        logs = {"loss_frame_before": softmax_output_loss(
            out.mel_pre, mel, num_classes)[0]}
        total = logs["loss_frame_before"]
        if out.mel_post is not None:
            logs["loss_frame_after"], acc = softmax_output_loss(
                out.mel_post, mel, num_classes)
            logs.update(acc)
            total = total + logs["loss_frame_after"]
    else:
        logs = {"loss_frame_before": (
            mse_loss_arelbo(out.mel_pre, mel)
            if use_sq_vae and not channel_wise else mel_l1(out.mel_pre))}
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
    if output_type == "softmax":
        logs["loss_total"] = total
        return total, logs
    if use_ssim and out.mel_post is not None:
        logs["loss_ssim"] = -ssim(out.mel_post, mel)
        total = total + logs["loss_ssim"]
    if out.sq_vae_loss is not None:
        logs["sq_vae_loss"] = out.sq_vae_loss
        logs["sq_vae_perplexity"] = out.sq_vae_perplexity
        total = total + out.sq_vae_loss
    logs["loss_total"] = total
    return total, logs
