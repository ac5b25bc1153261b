"""FastSpeech 2 train state and train step (the port of
transformer_tts_tpu/train/trainer.py: ``init_fastspeech2_state`` :122-162
and ``make_fastspeech2_train_step`` :186-260).

The step: forward in train mode (bf16 autocast when ``hp.amp``, with no
GradScaler, as the JAX package runs bf16 without loss scaling) -> the
losses in fp32 -> backward -> global-norm clip -> optimizer update ->
``step += 1``. Its logs stay tensors on the device, so the step itself
does not wait for the card; ``grad_norm`` is the norm before clipping.

Randomness: the state's ``generator`` (a CPU ``torch.Generator`` seeded
from ``hp.seed``, so a draw never syncs the card) gives the reference
init, a fresh seed for each in-kernel attention dropout and the scheduled-
sampling draws. The plain ``nn.Dropout`` layers take no generator, so
``init_fastspeech2_state`` seeds torch's default generators once from
``hp.seed`` for them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import (
    FastSpeech2, _variance_stats, build_fastspeech2, later_slice)
from transformer_tts_tpu_torch.ops.masks import create_masks
from transformer_tts_tpu_torch.train.losses import fastspeech2_loss
from transformer_tts_tpu_torch.train.schedule import (
    Optimizer, apply_reference_init, build_optimizer)

BATCH_KEYS = ("text", "pos_text", "mel", "pos_mel", "alignment", "f0",
              "energy")


class TrainState:
    """The model, its optimizer, the step count and the generator."""

    def __init__(self, model: FastSpeech2, optimizer: Optimizer,
                 generator: torch.Generator, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step


def _check_supported(hp: HParams) -> None:
    if hp.remat:
        later_slice("whole-forward rematerialisation (remat)",
                    "remaining tools")
    if hp.fix_mask:
        later_slice("band masks (fix_mask)", "AR Transformer-TTS")


def init_fastspeech2_state(hp: HParams, *, device="cuda") -> TrainState:
    """A FastSpeech 2 ``TrainState`` on ``device``: weights from
    ``hp.seed``, the reference init when ``hp.reference_init``, and the
    optimizer of ``hp.optimizer``. Seeds torch's default generators (the
    plain dropouts') from ``hp.seed``."""
    _check_supported(hp)
    torch.manual_seed(hp.seed)
    model = build_fastspeech2(hp, device=device, seed=hp.seed)
    generator = torch.Generator().manual_seed(hp.seed)
    if hp.reference_init:
        apply_reference_init(model, generator)
    optimizer = build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return TrainState(model, optimizer, generator)


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The step's arrays of a collated batch, as tensors on ``device``.
    Host arrays bound for the card go through pinned memory, so the copy
    is queued without waiting for the card."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for key in BATCH_KEYS:
        value = batch.get(key)
        if value is None:
            continue
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if on_card and value.device.type == "cpu":
            value = value.pin_memory()
        out[key] = value.to(device, non_blocking=True)
    return out


def make_fastspeech2_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` for collated batches
    (numpy arrays or tensors: text, pos_text, mel, pos_mel, alignment, f0,
    energy) padded to bucket shapes; the arrays go to ``device``."""
    _check_supported(hp)
    f0_stats = _variance_stats(hp.f0_mean, hp.f0_std)
    energy_stats = _variance_stats(hp.energy_mean, hp.energy_std)

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        model = state.model.train()
        out = model(b["text"], src_mask, b["mel"].shape[1], b["alignment"],
                    b.get("f0"), b.get("energy"), mel_mask,
                    generator=state.generator)
        total, logs = fastspeech2_loss(
            out, b["mel"], b["alignment"], b.get("f0"), b.get("energy"),
            src_mask=src_mask, mel_mask=mel_mask, masked=False,
            use_ssim=hp.use_ssim, use_sq_vae=hp.use_sq_vae,
            log_offset=hp.log_offset, channel_wise=hp.channel_wise,
            channel_weight=hp.channel_weight, output_type=hp.output_type,
            f0_stats=f0_stats, energy_stats=energy_stats)
        state.optimizer.zero_grad()
        total.backward()
        logs = {k: v.detach() for k, v in logs.items()}
        logs["grad_norm"] = state.optimizer.step()
        state.step += 1
        return state, logs

    return step_fn
