"""The mel-to-mel post-processing trainers (the port of
transformer_tts_tpu/train/post_trainers.py: ``build_post_model`` :41-63
(here models/fastspeech2.build_post_model), ``init_post_state`` :66-93,
``make_meltomel_train_step`` :96-171, ``make_meltomel_pregen_train_step``
:174-255 and ``make_integrate_train_step`` :258-344).

* ``mel-mel``: a frozen FastSpeech 2 teacher (eval mode, under
  ``torch.no_grad``, teacher-forced on the batch's durations, f0 and
  energy) gives the mel (mel_post, or mel_pre without the postnet) and the
  per-frame phone feature (``variance_adaptor_output``, or
  ``text_dur_predicted`` at versions 4 and 6) that a PostLowEnergy
  student (versions 1 and 5: v1, else v2) refines. Versions 3, 5 and 6
  are residual (the student's output added to the teacher's mel), the
  others replace it. The loss is the L1 against the target's first
  ``mel_dim_post`` dims, plus the VQ commitment with ``vq_code``.
  ``semantic_mask`` masks the student's input (and the phone feature with
  ``semantic_mask_phone``), the residual still added to the unmasked mel.
* the pregenerated route (``hp.teacher_suffix``): the same step on the
  batch's ``teacher_mel`` and ``teacher_phone`` (cli/teacher_forcing.py
  wrote them), with no teacher forward.
* ``text-mel-mel``: one FastSpeech 2 with the integrate post model
  trained jointly: L1 of mel_pre (and mel_post) against the mel, of the
  post output added to mel_post (or, at version 3, to mel_pre; at 8, 9
  and 10 the pair's first output added to mel_pre, and the second, the
  replace branch, against the target on its own, time-weighted under the
  semantic mask with ``time_weight``), 0.2 x the cosine-embedding loss of
  mel_pre against that sum with ``use_cosine_emb_loss``, the duration
  loss and L1 of pitch and energy.

The NaN guard of both mel-to-mel steps is the JAX steps': a non-finite
loss zeroes the gradients and the update is still taken (Adam's moments
decay and move the parameters, the Noam count advances), and the
BatchNorm and VQ statistics that the forward moved stay moved
(train/trainer._update's ``nan_guard``); ``skipped_nan`` says so. With
``accum_grad`` > 1 only the micro-step's own gradients are zeroed, and
under data parallelism the loss is tested over the ranks, so all of them
zero together. The integrate step has no guard, as in the JAX package.

Where the JAX step would compute garbage, the port raises ``ValueError``
when the step is made: the integrate step at versions 8, 9 and 10 with
``postnet_pred`` (JAX adds the output pair to mel_post as an array of
two), and at version 10 without ``intermediate_layers_out`` or with
``post_conformer`` (JAX unpacks the bare output along the batch).

Every step takes a ``TrainState`` (train/trainer.py) and a collated batch
and goes through ``state.forward_module``, so ``trainer.distribute``
makes it data-parallel; the semantic mask's draws and the kernels'
dropout seeds come from the state's generator.
"""

from __future__ import annotations

from typing import Dict

import torch

from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import (
    build_post_model, semantic_mask)
from transformer_tts_tpu_torch.ops.masks import create_masks
from transformer_tts_tpu_torch.train.losses import (
    cosine_embedding_loss, duration_loss, l1, time_weighted_l1)
from transformer_tts_tpu_torch.train.trainer import (
    TrainState, _init_state, _in_contexts, _update, batch_to)

MELMEL_BATCH_KEYS = ("text", "pos_text", "mel", "pos_mel", "alignment",
                     "f0", "energy", "spk_emb", "spk_emb_post")
PREGEN_BATCH_KEYS = ("pos_text", "mel", "pos_mel", "alignment",
                     "teacher_mel", "teacher_phone", "spk_emb_post")
INTEGRATE_BATCH_KEYS = MELMEL_BATCH_KEYS
RESIDUAL_VERSIONS = (3, 5, 6)
V1_VERSIONS = (1, 5)
COSINE_WEIGHT = 0.2


def init_post_state(hp: HParams, *, device="cuda") -> TrainState:
    """The student's ``TrainState`` on ``device``: ``build_post_model``'s
    weights from ``hp.seed``, the reference init when
    ``hp.reference_init``, the optimizer of ``hp.optimizer``."""
    return _init_state(build_post_model, hp, device)


def _student_loss(state: TrainState, hp: HParams, input_meltomel,
                  res_mel, phone_feature, mel_mask, mel, spk_emb_post):
    """The mel-to-mel student's forward and loss: (total, logs)."""
    state.model.train()
    model = state.forward_module
    diff = None
    if hp.version in V1_VERSIONS:
        outputs = model(input_meltomel, mel_mask, generator=state.generator)
    else:
        if phone_feature is None:
            raise ValueError(
                f"student version {hp.version} needs phone features: "
                "regenerate the corpus with cli/teacher_forcing "
                "--save_phone")
        outputs, _, diff = model(input_meltomel, mel_mask, phone_feature,
                                 spk_emb_post, generator=state.generator)
    if hp.version in RESIDUAL_VERSIONS:
        outputs = outputs + res_mel
    loss = l1(outputs, mel[:, :, :hp.mel_dim_post])
    logs = {"loss_post": loss}
    if hp.vq_code and diff is not None:
        logs["loss_vq"] = diff
        loss = loss + diff
    logs["loss_total"] = loss
    return loss, logs


def _masked_input(hp: HParams, state: TrainState, mel, phone, alignment):
    """(student input mel, phone feature) after the semantic mask."""
    if not hp.semantic_mask:
        return mel, phone
    masked_mel, masked_phone, _ = semantic_mask(
        mel, phone if hp.semantic_mask_phone else None, alignment,
        hp.mask_probability, generator=state.generator)
    return masked_mel, (masked_phone if masked_phone is not None
                        else phone)


def make_meltomel_train_step(teacher: torch.nn.Module, hp: HParams, *,
                             device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` of the frozen-teacher
    mel-to-mel student (``state`` from ``init_post_state``); ``teacher``
    a FastSpeech 2 on ``device``, which the step runs in eval mode and
    never changes."""
    teacher.requires_grad_(False)

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, MELMEL_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        teacher.eval()
        with torch.no_grad():
            t_out = teacher(b["text"], src_mask, b["mel"].shape[1],
                            b["alignment"], b.get("f0"), b.get("energy"),
                            mel_mask, spk_emb=b.get("spk_emb"))
        res_mel = t_out.mel_post if hp.postnet_pred else t_out.mel_pre
        input_meltomel, phone = _masked_input(
            hp, state, res_mel, t_out.variance_adaptor_output,
            b["alignment"])
        if hp.version in (4, 6):
            phone = t_out.text_dur_predicted
        total, logs = _student_loss(state, hp, input_meltomel, res_mel,
                                    phone, mel_mask, b["mel"],
                                    b.get("spk_emb_post"))
        return _update(state, total, logs, nan_guard=True)

    return _in_contexts(step_fn)


def make_meltomel_pregen_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` of the mel-to-mel
    student on the pregenerated corpus: the batch's ``teacher_mel``
    (normalized, padded like ``mel``) and, for versions other than 1 and
    5, ``teacher_phone`` take the teacher's place."""

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, PREGEN_BATCH_KEYS)
        _, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        res_mel = b["teacher_mel"]
        input_meltomel, phone = _masked_input(
            hp, state, res_mel, b.get("teacher_phone"), b["alignment"])
        total, logs = _student_loss(state, hp, input_meltomel, res_mel,
                                    phone, mel_mask, b["mel"],
                                    b.get("spk_emb_post"))
        return _update(state, total, logs, nan_guard=True)

    return _in_contexts(step_fn)


def check_integrate(hp: HParams) -> None:
    """Raise ``ValueError`` for the integrate versions that the JAX step
    computes wrongly (see the module docstring)."""
    if hp.version in (8, 9, 10) and hp.postnet_pred:
        raise ValueError(
            f"version {hp.version} with postnet_pred=True: the JAX step "
            "adds the (residual, replace) pair to mel_post as one array "
            "of two; train versions 8-10 with postnet_pred=False")
    if hp.version == 10 and (not hp.intermediate_layers_out
                             or hp.post_conformer):
        raise ValueError(
            "version 10 replaces with the post model's first tap: set "
            "intermediate_layers_out on a transformer student (the JAX "
            "step unpacks the bare output along the batch)")


def make_integrate_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` of the text-mel-mel
    model (``state`` from train/trainer.init_fastspeech2_state of
    ``architecture = "text-mel-mel"`` hparams)."""
    check_integrate(hp)

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, INTEGRATE_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        state.model.train()
        mel = b["mel"]
        out = state.forward_module(
            b["text"], src_mask, mel.shape[1], b["alignment"], b.get("f0"),
            b.get("energy"), mel_mask, spk_emb=b.get("spk_emb"),
            spk_emb_post=b.get("spk_emb_post"), generator=state.generator)
        target = mel[:, :, :hp.mel_dim_post]
        logs = {"loss_frame_before": l1(out.mel_pre, mel)}
        total = logs["loss_frame_before"]
        if out.mel_post is not None:
            logs["loss_frame_after"] = l1(out.mel_post, target)
            total = total + logs["loss_frame_after"]
            res_outputs = out.post_output + out.mel_post
        elif hp.version == 3:
            res_outputs = out.post_output + out.mel_pre
        elif hp.version in (8, 9, 10):
            post_res, post_replace = out.post_output
            res_outputs = post_res + out.mel_pre
            if (hp.semantic_mask and hp.time_weight is not None
                    and out.mask_frames is not None):
                rep_loss = time_weighted_l1(post_replace, target,
                                            out.mask_frames, hp.time_weight,
                                            hp.mel_dim)
            else:
                rep_loss = l1(post_replace, target)
            logs["replace_loss"] = rep_loss
            total = total + rep_loss
        else:
            res_outputs = out.post_output
        logs["loss_post_pro"] = l1(res_outputs, target)
        total = total + logs["loss_post_pro"]
        if hp.use_cosine_emb_loss:
            logs["loss_cosine_emb"] = cosine_embedding_loss(out.mel_pre,
                                                            res_outputs)
            total = total + COSINE_WEIGHT * logs["loss_cosine_emb"]
        logs["loss_duration"] = duration_loss(
            out.log_duration, b["alignment"], None, hp.log_offset)
        total = total + logs["loss_duration"]
        if out.pitch is not None and b.get("f0") is not None:
            logs["loss_f0"] = l1(out.pitch, b["f0"])
            total = total + logs["loss_f0"]
        if out.energy is not None and b.get("energy") is not None:
            logs["loss_energy"] = l1(out.energy, b["energy"])
            total = total + logs["loss_energy"]
        logs["loss_total"] = total
        return _update(state, total, logs)

    return _in_contexts(step_fn)
