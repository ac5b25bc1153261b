"""Vocoder GAN training: the D-then-G step, checkpoints and the generator
export (the port of transformer_tts_tpu/vocoder/trainer.py:
``build_vocoder``, ``build_discriminator``, ``init_vocoder_state``,
``make_vocoder_train_step`` :52-216, and the checkpoint, export and
``restore_generator_params`` :219-280).

The step's recipe is the JAX package's (HiFi-GAN):

* the generator vocodes the log-mel of the audio (or, with
  ``predicted_mel_inputs``, the acoustic model's mel for the segment);
* the discriminator is updated first, on the real audio and the detached
  fake: LSGAN, sum of (D(real) - 1)^2 and D(fake)^2 means;
* the generator's loss then uses the **updated** discriminator: LSGAN
  (D(fake) - 1)^2, plus ``vocoder_lambda_fm`` times the mean L1 between
  every real and fake feature map, plus ``vocoder_lambda_mel`` times the
  L1 between the fake's and the audio's log-mels (``mel_of`` drops the
  centre-padded last frame);
* both optimizers are AdamW (b1 ``vocoder_adam_b1``, b2
  ``vocoder_adam_b2``, eps 1e-8, weight decay 0) at optax's non-staircase
  ``exponential_decay``: lr * decay^(n / decay_steps) at update n.

The generator runs under bf16 autocast when ``hp.amp`` is set; the
discriminator, the mels and the losses run in fp32.

Checkpoints are the port's own ``torch.save`` files: ``vocoder_<step>/``
holds ``generator.pt``, ``discriminator.pt`` and ``train_state.pt`` (the
step and both optimizers), and the ``generator/`` export holds
``generator.pt`` alone. ``restore_generator_params`` reads either.
"""

from __future__ import annotations

import math
import os
import re
import shutil
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.ops.melspectrogram import log_mel_spectrogram
from transformer_tts_tpu_torch.train.checkpoint import TRAIN_STATE_NAME
from transformer_tts_tpu_torch.vocoder.discriminator import (
    VocoderDiscriminator)
from transformer_tts_tpu_torch.vocoder.generator import (
    HiFiGANGenerator, ISTFTVocoder, init_vocoder_parameters)

GENERATOR_NAME = "generator.pt"
DISCRIMINATOR_NAME = "discriminator.pt"
ADAM_EPS = 1e-8                 # optax.adamw's default
_VOCODER_RE = re.compile(r"^vocoder_(\d+)$")


def build_vocoder(hp: HParams, *, amp: Optional[bool] = None,
                  device="cuda", seed: int = 0) -> nn.Module:
    """``hp.vocoder_type`` "hifigan" or "istft", random weights from
    ``seed``; ``amp`` (default ``hp.amp``) runs it under bf16 autocast."""
    amp = hp.amp if amp is None else amp
    vtype = (hp.vocoder_type or "hifigan").lower()
    if vtype == "istft":
        model = ISTFTVocoder(
            mel_dim=hp.mel_dim, channels=hp.vocoder_convnext_channels,
            mlp_dim=hp.vocoder_convnext_mlp,
            num_layers=hp.vocoder_convnext_layers,
            n_fft=hp.vocoder_istft_n_fft,
            hop_length=math.prod(hp.vocoder_upsample_rates),
            amp=amp)
    elif vtype == "hifigan":
        model = HiFiGANGenerator(
            mel_dim=hp.mel_dim,
            upsample_rates=tuple(hp.vocoder_upsample_rates),
            upsample_kernel_sizes=tuple(hp.vocoder_upsample_kernel_sizes),
            upsample_initial_channel=hp.vocoder_channels,
            resblock_kernel_sizes=tuple(hp.vocoder_resblock_kernel_sizes),
            resblock_dilations=tuple(
                tuple(d) for d in hp.vocoder_resblock_dilations),
            upsample_mode=hp.vocoder_upsample_mode, amp=amp)
    else:
        raise ValueError(f"unknown vocoder_type {hp.vocoder_type!r}")
    init_vocoder_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def build_discriminator(hp: HParams, *, device="cuda",
                        seed: int = 1) -> VocoderDiscriminator:
    model = VocoderDiscriminator(periods=tuple(hp.vocoder_periods),
                                 num_scales=hp.vocoder_num_scales)
    init_vocoder_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def vocoder_schedule(hp: HParams):
    """optax ``exponential_decay`` (not staircase) at update ``count``."""
    def schedule(count: int) -> float:
        return hp.vocoder_lr * hp.vocoder_lr_decay ** (
            count / hp.vocoder_lr_decay_steps)
    return schedule


def _optimizer(model: nn.Module, hp: HParams) -> torch.optim.AdamW:
    return torch.optim.AdamW(
        model.parameters(), lr=hp.vocoder_lr,
        betas=(hp.vocoder_adam_b1, hp.vocoder_adam_b2), eps=ADAM_EPS,
        weight_decay=0.0)


@dataclass
class VocoderTrainState:
    step: int
    generator: nn.Module
    discriminator: VocoderDiscriminator
    g_opt: torch.optim.AdamW
    d_opt: torch.optim.AdamW


def init_vocoder_state(hp: HParams, segment_size: int, *, device="cuda",
                       seed: Optional[int] = None) -> VocoderTrainState:
    """Generator and discriminator with random weights from ``seed``
    (default ``hp.seed``) and their optimizers, in train mode."""
    seed = hp.seed if seed is None else seed
    gen = build_vocoder(hp, device=device, seed=seed).train()
    if segment_size % gen.hop_length:
        raise ValueError(
            f"vocoder_segment_size {segment_size} must be a multiple of "
            f"the generator's hop {gen.hop_length} "
            "(= prod(vocoder_upsample_rates))")
    disc = build_discriminator(hp, device=device, seed=seed + 1).train()
    return VocoderTrainState(step=0, generator=gen, discriminator=disc,
                             g_opt=_optimizer(gen, hp),
                             d_opt=_optimizer(disc, hp))


def _ls_real(logits):
    return torch.mean((logits.float() - 1.0) ** 2)


def _ls_fake(logits):
    return torch.mean(logits.float() ** 2)


@contextmanager
def _frozen(model: nn.Module):
    """No weight gradients for ``model`` inside (the input's still flow)."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_vocoder_train_step(hp: HParams, mel_cfg: Dict[str, Any], *,
                            predicted_mel_inputs: bool = False):
    """-> ``step(state, audio (B, N) fp32[, mel (B, N / hop, mel_dim)])``,
    which updates ``state`` in place and returns the scalars ``loss_d``,
    ``loss_g``, ``loss_adv``, ``loss_fm`` and ``loss_mel`` as tensors on
    the device. The mel argument is given exactly when
    ``predicted_mel_inputs`` (the fine-tuning mode) is set; the loss's
    target stays the audio's own mel."""
    lam_mel = hp.vocoder_lambda_mel
    lam_fm = hp.vocoder_lambda_fm
    schedule = vocoder_schedule(hp)

    def update(opt: torch.optim.Optimizer, loss: torch.Tensor, lr: float):
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()

    def mel_of(audio, hop: int):
        m = log_mel_spectrogram(audio, **mel_cfg)
        return m[:, : audio.shape[1] // hop]       # drop the centre frame

    def step(state: VocoderTrainState, audio: torch.Tensor,
             in_mel: Optional[torch.Tensor] = None):
        if (in_mel is not None) != predicted_mel_inputs:
            raise ValueError("pass the acoustic model's mel exactly when "
                             "predicted_mel_inputs is set")
        gen, disc = state.generator, state.discriminator
        lr = schedule(state.step)            # both have made state.step
        with torch.no_grad():
            mel = mel_of(audio, gen.hop_length)
        fake = gen(in_mel if predicted_mel_inputs else mel)

        # the discriminator first, on the detached fake
        d_loss = (sum(_ls_real(lr) for lr, _ in disc(audio))
                  + sum(_ls_fake(lf) for lf, _ in disc(fake.detach())))
        update(state.d_opt, d_loss, lr)

        # then the generator, against the updated discriminator
        with _frozen(disc):
            outs_f = disc(fake)
            with torch.no_grad():
                outs_r = disc(audio)
            adv = sum(_ls_real(lf) for lf, _ in outs_f)
            fm = sum(torch.mean(torch.abs(fr.float() - ff.float()))
                     for (_, fmaps_r), (_, fmaps_f) in zip(outs_r, outs_f)
                     for fr, ff in zip(fmaps_r, fmaps_f))
            mel_l1 = torch.mean(torch.abs(mel_of(fake, gen.hop_length)
                                          - mel))
            g_loss = adv + lam_fm * fm + lam_mel * mel_l1
            update(state.g_opt, g_loss, lr)
        state.step += 1
        return {"loss_d": d_loss.detach(), "loss_g": g_loss.detach(),
                "loss_adv": adv.detach(), "loss_fm": fm.detach(),
                "loss_mel": mel_l1.detach()}

    return step


# ---- checkpoints ------------------------------------------------------------

def _cpu_state(model: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def _fresh_dir(path: str) -> str:
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    return path


def save_vocoder_checkpoint(save_dir: str, state: VocoderTrainState,
                            tag: int) -> str:
    path = _fresh_dir(os.path.abspath(os.path.join(save_dir,
                                                   f"vocoder_{tag}")))
    torch.save(_cpu_state(state.generator),
               os.path.join(path, GENERATOR_NAME))
    torch.save(_cpu_state(state.discriminator),
               os.path.join(path, DISCRIMINATOR_NAME))
    torch.save({"step": state.step, "g_opt": state.g_opt.state_dict(),
                "d_opt": state.d_opt.state_dict()},
               os.path.join(path, TRAIN_STATE_NAME))
    return path


def restore_vocoder_checkpoint(save_dir: str, state: VocoderTrainState,
                               tag: Optional[int] = None
                               ) -> VocoderTrainState:
    """Load ``vocoder_<tag>`` (default: the newest) into ``state``."""
    if tag is None:
        tags = sorted(int(m.group(1)) for m in map(
            _VOCODER_RE.match, os.listdir(save_dir)) if m)
        if not tags:
            raise FileNotFoundError(f"no vocoder checkpoints in {save_dir}")
        tag = tags[-1]
    path = os.path.join(save_dir, f"vocoder_{tag}")
    device = next(state.generator.parameters()).device
    state.generator.load_state_dict(torch.load(
        os.path.join(path, GENERATOR_NAME), map_location=device,
        weights_only=True))
    state.discriminator.load_state_dict(torch.load(
        os.path.join(path, DISCRIMINATOR_NAME), map_location=device,
        weights_only=True))
    payload = torch.load(os.path.join(path, TRAIN_STATE_NAME),
                         map_location=device, weights_only=False)
    state.step = payload["step"]
    state.g_opt.load_state_dict(payload["g_opt"])
    state.d_opt.load_state_dict(payload["d_opt"])
    return state


def export_generator(save_dir: str, state: VocoderTrainState) -> str:
    """Write the generator alone (what synthesis loads) to
    ``save_dir/generator/``."""
    path = _fresh_dir(os.path.abspath(os.path.join(save_dir, "generator")))
    torch.save(_cpu_state(state.generator),
               os.path.join(path, GENERATOR_NAME))
    return path


def restore_generator_params(path: str, device="cpu") -> Dict[str,
                                                              torch.Tensor]:
    """The generator's ``state_dict`` from a ``vocoder_<k>`` checkpoint or
    a ``generator`` export, on ``device``."""
    return torch.load(os.path.join(path, GENERATOR_NAME),
                      map_location=device, weights_only=True)
