"""Train states and train steps of FastSpeech 2, the AR Transformer-TTS
and the SQ-VAE FastSpeech 2 (the port of transformer_tts_tpu/train/
trainer.py: ``init_fastspeech2_state`` :122-162,
``make_fastspeech2_train_step`` :186-260, ``init_transformer_state``
:294-329, ``_guided_attention_loss`` :332-354,
``make_transformer_train_step`` :357-428, ``init_sq_fastspeech2_state``
and ``make_sq_fastspeech2_train_step`` :435-558,
``make_fastspeech2_eval_step`` :263-287; its ``build_sq_fastspeech2`` is
in models/fastspeech2_sq.py; the mel-to-mel trainers are
train/post_trainers.py).

The step: forward in train mode (bf16 autocast when ``hp.amp``, with no
GradScaler, as the JAX package runs bf16 without loss scaling) -> the
losses in fp32 -> backward -> global-norm clip -> optimizer update ->
``step += 1``. Its logs stay tensors on the device, so the step itself
does not wait for the card; ``grad_norm`` is the norm before clipping.

Randomness: the state's ``generator`` (a CPU ``torch.Generator`` seeded
from ``hp.seed``, so a draw never syncs the card) gives the reference
init, a fresh seed for each in-kernel attention dropout and the scheduled-
sampling draws. The plain ``nn.Dropout`` layers (the AR prenet's among
them) take no generator, so ``init_fastspeech2_state`` and
``init_transformer_state`` seed torch's default generators once from
``hp.seed`` for them.

The AR step is teacher-forced: the decoder reads ``mel[:, :-r:r]`` (the go
frame and every r-th frame, ``pos_mel[:, :-r:r]`` its positions) and
predicts each next group of r frames against ``mel[:, r:]`` and
``stop_token[:, r:]``. Its masked self-attention takes K3 (the kernel
path needs T_dec >= ``FLASH_MIN_KEY_LEN``);
``guided_attention_weight > 0`` asks for the attention maps, which puts
every attention on the masked path, as in the JAX package. With ``gst``
the style comes from the same decoder input; the reference encoder's
BatchNorm statistics move in the step, as flax's ``batch_stats`` do.
With ``decoder_type = "tacotron2"`` the decoder reads the full-rate
``mel[:, r:]`` (the JAX file's :372-386), the masks are the text's only,
and the loss targets are the same; its T/r steps run as an eager Python
loop (the JAX package's ``lax.scan``), each drawing its prenet dropout
and zoneout from the state's generator. The AR step refuses the discrete
mode (``output_type``), where the JAX step fails: it reshapes the (B, t,
mel*r) output by the targets' 2 code streams and takes an L1 of float
frames against int codes.

Conditioned batches carry ``spk_emb`` ((B,) ids or (B, 512) x-vectors),
``accent`` (B, L) and ``hop_size`` (B,); the steps pass them to the
model (the AR step the speakers only). With ``CTC_training`` the
FastSpeech 2 step adds 0.2 x the CTC loss (``loss_ctc``) of the decoder's
tap against the text ids, over each row's mel frames and its phones
(blank and padding id 0), as the JAX step does (:207-248).

The SQ-VAE steps (``make_sq_fastspeech2_train_step``, and
``make_fastspeech2_train_step`` with ``use_sq_vae``) anneal the
Gumbel-softmax temperature as exp(-1e-5 * step), ``step`` the optimizer's
step count before the update, and draw the noise on the model's device
(models/sq_vae.py). The SQ model learns durations without targets: its
step drops the alignment and takes mean_b |sum_l exp(log_d) - mel_len|
over valid phones as the duration loss, the AR-ELBO MSE on mel_pre, L1 on
mel_post, f0 and energy, and the SQ-VAE loss.

``remat`` (the FastSpeech 2 step, JAX :219-222) runs the whole forward
under ``torch.utils.checkpoint`` (``use_reentrant=False``), so the
backward recomputes it. The recompute must draw what the first run drew:
the state's generator (the attention kernels' dropout seeds, the SQ-VAE's
Gumbel noise) is set back to its state before the forward at the start
of each run, torch's default generators (the plain dropouts) are kept by
the checkpoint's ``preserve_rng_state``, and the recompute leaves the
BatchNorm running statistics still, so they move once per step, as
flax's ``batch_stats`` do under ``jax.checkpoint``. The checkpoint sits
inside the module the step calls (``StepModule``), the one DDP wraps, so
the recompute runs the model alone and never DDP's forward a second time.

Data parallelism (``distribute``): the step module runs through a DDP
wrapper (``state.ddp``) while ``state.model`` stays the bare module; the
BatchNorms take the global batch's statistics and the losses' masked
means the global counts (train/losses.py ``global_means``); the logs are
averaged over the ranks, so they are the global batch's; the rank is
folded into the dropout streams after the initial draw, so rows of
different ranks draw different masks; with ``accum_grad`` > 1 the
non-final micro-steps run under DDP's ``no_sync``.

On a mesh (``distribute(state, device, mesh)``, parallel/mesh.py) the
model is first split over the ``model`` group (parallel/tp.py: heads and
FFN channels; the optimizer's moments and its global norm follow), then
wrapped in DDP over the data-parallel group, and every reduction above
(the statistics, the means, the logs, the NaN guard) runs over that group
and not the world; the data coordinate, not the rank, is folded into the
dropout streams, so the ranks of one ``model`` group draw the same seeds
and masks.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from transformer_tts_tpu_torch.config import HParams
from transformer_tts_tpu_torch.models.fastspeech2 import (
    _variance_stats, build_fastspeech2)
from transformer_tts_tpu_torch.models.fastspeech2_sq import (
    build_sq_fastspeech2)
from transformer_tts_tpu_torch.models.transformer_tts import (
    build_transformer_tts, check_supported as check_ar_supported)
from transformer_tts_tpu_torch.ops.feedforward import frozen_statistics
from transformer_tts_tpu_torch.ops.masks import create_masks
from transformer_tts_tpu_torch.train.losses import (
    ctc_aux_loss, fastspeech2_loss, global_means, l1, mean_count,
    mse_loss_arelbo, transformer_tts_loss)
from transformer_tts_tpu_torch.train.schedule import (
    Optimizer, apply_reference_init, build_optimizer)

CONDITIONING_KEYS = ("spk_emb", "accent", "hop_size")
FS2_BATCH_KEYS = ("text", "pos_text", "mel", "pos_mel", "alignment", "f0",
                  "energy") + CONDITIONING_KEYS
AR_BATCH_KEYS = ("text", "pos_text", "mel", "pos_mel", "stop_token",
                 "spk_emb")
CTC_WEIGHT = 0.2
SQ_BATCH_KEYS = ("text", "pos_text", "mel", "pos_mel", "f0", "energy",
                 "spk_emb", "accent")


class StepModule(nn.Module):
    """The module a train step calls, and the one DDP wraps: the model,
    whose forward runs under ``remat_forward`` when the step asks
    (``remat=True``). So the backward's recompute stays inside DDP's
    forward and calls the model alone."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, remat: bool = False, **kwargs):
        if remat:
            return remat_forward(self.model, *args, **kwargs)
        return self.model(*args, **kwargs)


class TrainState:
    """The model, its optimizer, the step count and the generator; under
    data parallelism also the DDP wrapper of its ``StepModule`` (``ddp``)
    and the group it averages over (``data_group``: None for the default
    group), under tensor parallelism the ``model`` group (``model_group``)
    its weights are split over."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 generator: torch.Generator, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.generator = generator
        self.step = step
        self.step_module = StepModule(model)
        self.ddp: Optional[nn.Module] = None
        self.data_group = None
        self.model_group = None

    @property
    def forward_module(self) -> nn.Module:
        """The module a train step calls: the DDP wrapper, if any, else
        the ``StepModule``."""
        return self.ddp if self.ddp is not None else self.step_module

    def sync_context(self):
        """DDP's ``no_sync`` for a micro-step whose gradients stay local
        (not the last of an accumulation), else nothing."""
        if self.ddp is None or self.optimizer.syncs:
            return nullcontext()
        return self.ddp.no_sync()

    def means(self):
        """The losses' masked means over the data-parallel group."""
        import torch.distributed as dist
        if self.ddp is None:
            return global_means(None)
        return global_means(self.data_group or dist.group.WORLD)


def fold_rank(state: TrainState, rank: int) -> None:
    """Fold ``rank`` into the state's generator and torch's default
    generators: one draw from the state's generator, the same on every
    rank (every rank built the same state), then each stream reseeded
    from it and the rank."""
    base = int(torch.randint(0, 2 ** 62, (), generator=state.generator))
    state.generator.manual_seed((base * 1_000_003 + 2 * rank) % 2 ** 63)
    torch.manual_seed((base * 1_000_003 + 2 * rank + 1) % 2 ** 63)


def distribute(state: TrainState, device=None, mesh=None) -> TrainState:
    """Make ``state`` a data-parallel rank's (after
    ``parallel.init_distributed``): the model wrapped in DDP over the
    default group (rank 0's weights broadcast), the BatchNorms'
    statistics global and the rank folded into the dropout streams.
    ``state.model`` stays the bare module. On a ``mesh``
    (parallel/mesh.py) the model is first split over its ``model`` group
    (``tensor_parallel``; the optimizer's moments sliced alike), DDP runs
    over the data-parallel group, whose first rank broadcasts its shards,
    and the data coordinate is folded into the dropout streams."""
    import torch.distributed as dist
    from transformer_tts_tpu_torch.parallel import mesh as pm
    if mesh is None:
        state.ddp = pm.data_parallel(state.step_module, device)
        fold_rank(state, dist.get_rank())
        return state
    from transformer_tts_tpu_torch.parallel import tp
    group = mesh.get_group("model")
    if tp.tensor_parallel(state.model, group):
        state.model_group = group
        tp.shard_optimizer_state(state.optimizer, group)
    state.data_group = pm.data_group(mesh)
    state.ddp = pm.data_parallel(state.step_module, device, mesh)
    fold_rank(state, pm.data_coordinate(mesh)[0])
    return state


def _init_state(build, hp: HParams, device) -> TrainState:
    torch.manual_seed(hp.seed)
    model = build(hp, device=device, seed=hp.seed)
    generator = torch.Generator().manual_seed(hp.seed)
    if hp.reference_init:
        apply_reference_init(model, generator)
    optimizer = build_optimizer(
        model.parameters(), hp.optimizer, hp.d_model_decoder,
        hp.warmup_factor, hp.warmup_step, hp.learning_rate, hp.clip,
        hp.accum_grad)
    return TrainState(model, optimizer, generator)


def init_fastspeech2_state(hp: HParams, *, device="cuda") -> TrainState:
    """A FastSpeech 2 ``TrainState`` on ``device``: weights from
    ``hp.seed``, the reference init when ``hp.reference_init``, and the
    optimizer of ``hp.optimizer``. Seeds torch's default generators (the
    plain dropouts') from ``hp.seed``."""
    return _init_state(build_fastspeech2, hp, device)


def init_transformer_state(hp: HParams, *, device="cuda") -> TrainState:
    """The AR Transformer-TTS ``TrainState``, as
    ``init_fastspeech2_state``."""
    return _init_state(build_transformer_tts, hp, device)


def init_sq_fastspeech2_state(hp: HParams, *, device="cuda") -> TrainState:
    """The SQ-VAE FastSpeech 2 ``TrainState``, as
    ``init_fastspeech2_state``."""
    return _init_state(build_sq_fastspeech2, hp, device)


def sq_temperature(step: int) -> float:
    """The Gumbel-softmax temperature at optimizer step ``step``."""
    return math.exp(-1e-5 * step)


def batch_to(batch: Dict, device, keys) -> Dict[str, torch.Tensor]:
    """The step's arrays (``keys``) of a collated batch, as tensors on
    ``device``. Host arrays bound for the card go through pinned memory,
    so the copy is queued without waiting for the card."""
    on_card = torch.device(device).type == "cuda"
    out = {}
    for key in keys:
        value = batch.get(key)
        if value is None:
            continue
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(value)
        if on_card and value.device.type == "cpu":
            value = value.pin_memory()
        out[key] = value.to(device, non_blocking=True)
    return out


def remat_forward(model: nn.Module, *args, generator: torch.Generator,
                  **kwargs):
    """``model(*args, generator=generator, **kwargs)`` under a
    non-reentrant checkpoint: the backward recomputes it with the same
    draws from ``generator`` and torch's default ones, and with the
    BatchNorm running statistics still (they moved in the first run)."""
    from torch.utils.checkpoint import checkpoint
    before = generator.get_state()
    runs = []

    def run(*args, **kwargs):
        generator.set_state(before)
        again = bool(runs)
        runs.append(1)
        with frozen_statistics(model) if again else nullcontext():
            return model(*args, generator=generator, **kwargs)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=True, **kwargs)


def make_fastspeech2_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` for collated batches
    (numpy arrays or tensors: text, pos_text, mel, pos_mel, alignment, f0,
    energy) padded to bucket shapes; the arrays go to ``device``."""
    f0_stats = _variance_stats(hp.f0_mean, hp.f0_std)
    energy_stats = _variance_stats(hp.energy_mean, hp.energy_std)

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, FS2_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"],
                                          fix_mask=hp.fix_mask)
        state.model.train()
        model = state.forward_module
        temperature = (sq_temperature(state.step) if hp.use_sq_vae
                       else None)

        with state.sync_context(), state.means():
            out = model(b["text"], src_mask, b["mel"].shape[1],
                        b.get("alignment"), b.get("f0"), b.get("energy"),
                        mel_mask, spk_emb=b.get("spk_emb"),
                        accent=b.get("accent"), hop_size=b.get("hop_size"),
                        temperature=temperature, generator=state.generator,
                        remat=hp.remat)
            total, logs = fastspeech2_loss(
                out, b["mel"], b["alignment"], b.get("f0"), b.get("energy"),
                src_mask=src_mask, mel_mask=mel_mask, masked=False,
                use_ssim=hp.use_ssim, use_sq_vae=hp.use_sq_vae,
                log_offset=hp.log_offset, channel_wise=hp.channel_wise,
                channel_weight=hp.channel_weight, output_type=hp.output_type,
                f0_stats=f0_stats, energy_stats=energy_stats)
            if hp.CTC_training:
                logs["loss_ctc"] = ctc_aux_loss(
                    out.ctc_logits, mel_mask[:, 0, :].sum(1), b["text"],
                    (b["text"] != 0).sum(1))
                total = total + CTC_WEIGHT * logs["loss_ctc"]
                logs["loss_total"] = total
            return _update(state, total, logs)

    return step_fn


def _in_contexts(body):
    """``body(state, batch)`` under the state's ``sync_context`` and
    ``means``."""
    def step_fn(state: TrainState, batch: Dict):
        with state.sync_context(), state.means():
            return body(state, batch)
    return step_fn


def _group_sum(state: TrainState, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data-parallel ranks (``x`` without DDP)."""
    if state.ddp is None:
        return x
    import torch.distributed as dist
    x = x.float().clone()
    dist.all_reduce(x, group=state.data_group)
    return x


def _group_mean_(tensors, group) -> None:
    """Average ``tensors`` over the data-parallel ranks of ``group`` (None:
    every rank), in place."""
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, f in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(f.view_as(t))


def _update(state: TrainState, total: torch.Tensor, logs: Dict, *,
            nan_guard: bool = False):
    """Backward, clip and optimizer update; ``step += 1``. Under data
    parallelism the logs are averaged over the ranks (the global batch's
    values, as every loss's average over the ranks is). ``nan_guard``
    (the mel-to-mel steps) zeroes this micro-step's gradients when
    ``total`` is not finite and still takes the update, as the JAX steps
    do: the moments decay, the parameters move by them and the schedule
    advances; the logs gain ``skipped_nan``. Mid-accumulation the partial
    sum of the earlier micro-steps stays (optax's MultiSteps keeps it).
    Under data parallelism ``total`` is tested over the group, as JAX
    tests the global batch's loss, so every rank zeroes together. No host
    sync, except on the last micro-step of an accumulation under data
    parallelism, where a skipped micro-step's kept sum is averaged over
    the ranks as DDP averaged the whole sum."""
    opt = state.optimizer
    opt.zero_grad()
    partial = None
    if nan_guard and opt.mini_step > 0:
        partial = [p.grad.detach().clone() for p in opt.params]
    last = opt.syncs
    total.backward()
    logs = {k: v.detach() for k, v in logs.items()}
    if nan_guard:
        finite = torch.isfinite(_group_sum(state, total.detach()))
        if partial is None:
            partial = [None] * len(opt.params)
        elif state.ddp is not None and last and not bool(finite):
            _group_mean_(partial, state.data_group)
        for p, kept in zip(opt.params, partial):
            if p.grad is not None:
                p.grad = torch.where(
                    finite, p.grad,
                    kept if kept is not None else torch.zeros_like(p.grad))
        logs["skipped_nan"] = ~finite
    logs["grad_norm"] = state.optimizer.step()
    state.step += 1
    if state.ddp is not None:
        import torch.distributed as dist
        keys = sorted(logs)
        flat = torch.stack([logs[k].float().reshape(()) for k in keys])
        dist.all_reduce(flat, group=state.data_group)
        flat = flat / dist.get_world_size(state.data_group)
        logs = dict(zip(keys, flat.unbind()))
    return state, logs


def _guided_attention_loss(attn: torch.Tensor, text_len: torch.Tensor,
                           query_len: torch.Tensor,
                           sigma: float) -> torch.Tensor:
    """The diagonal attention prior on the cross-attention maps ``attn``
    (B, layers, H, T_q, L), averaged over layers and heads, or (B, T_q,
    L): the mean over valid (t, l) of A[t, l] * (1 - exp(-(l/L - t/T)^2 /
    (2 sigma^2))), 1-based t and l."""
    a = attn.float()
    if a.dim() == 5:
        a = a.mean(dim=(1, 2))
    t_q, n_text = a.shape[-2:]
    t_idx = (torch.arange(t_q, device=a.device) + 1.0)[None, :, None]
    l_idx = (torch.arange(n_text, device=a.device) + 1.0)[None, None, :]
    ql = query_len.float().clamp(min=1.0)[:, None, None]
    tl = text_len.float().clamp(min=1.0)[:, None, None]
    w = 1.0 - torch.exp(-((l_idx / tl - t_idx / ql) ** 2)
                        / (2.0 * sigma ** 2))
    valid = (t_idx <= ql) & (l_idx <= tl)
    return (a * w * valid).sum() / mean_count(valid.sum())


def make_transformer_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` of the AR model for
    collated batches (text, pos_text, mel with the go frame first and a
    length a multiple of r, pos_mel, stop_token 1.0 past each row's
    frames), padded to bucket shapes; the arrays go to ``device``."""
    check_ar_supported(hp)
    if hp.output_type:
        raise ValueError(
            f"output_type={hp.output_type!r} in the AR train step: the JAX "
            "package's step reshapes the (B, t, mel_dim*r) output by the "
            "targets' 2 code streams and takes an L1 of float frames "
            "against (B, T, 2) int codes, so it has no result to port")
    r = hp.reduction_rate
    ga_w = float(hp.guided_attention_weight or 0.0)
    ga_sigma = float(hp.guided_attention_sigma)
    is_taco = hp.decoder_type.lower() == "tacotron2"

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, AR_BATCH_KEYS)
        mel = b["mel"]
        n, _, mel_dim = mel.shape
        if is_taco:
            mel_input = mel[:, r:]
            src_mask, trg_mask = create_masks(b["pos_text"], None,
                                              model="transformer")
        else:
            mel_input = mel[:, :-r:r]
            src_mask, trg_mask = create_masks(b["pos_text"],
                                              b["pos_mel"][:, :-r:r],
                                              model="transformer")
        state.model.train()
        model = state.forward_module
        out = model(b["text"], mel_input, src_mask, trg_mask,
                    spk_emb=b.get("spk_emb"), collect_attn=ga_w > 0,
                    generator=state.generator)
        t = out.mel_pre.shape[1]
        total, logs = transformer_tts_loss(
            out.mel_pre.reshape(n, t * r, mel_dim),
            out.mel_post.reshape(n, t * r, mel_dim),
            out.stop_token.reshape(n, t * r), mel[:, r:],
            b["stop_token"][:, r:], positive_weight=hp.positive_weight)
        if ga_w > 0:
            q_len = (b["pos_mel"] != 0).sum(1) // r
            t_len = (b["pos_text"] != 0).sum(1)
            ga = _guided_attention_loss(out.attn_dec_enc, t_len, q_len,
                                        ga_sigma)
            logs["loss_guided_attention"] = ga
            total = total + ga_w * ga
            logs["loss_total"] = total
        return _update(state, total, logs)

    return _in_contexts(step_fn)


def make_sq_fastspeech2_train_step(hp: HParams, *, device="cuda"):
    """``step_fn(state, batch) -> (state, logs)`` of the SQ-VAE FastSpeech
    2 for collated batches (text, pos_text, mel, pos_mel, f0, energy and
    the speakers and accents the hparams ask for; an alignment is
    ignored); the arrays go to ``device``."""

    def step_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, SQ_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        state.model.train()
        model = state.forward_module
        mel = b["mel"]
        out = model(b["text"], src_mask, mel.shape[1], None, b.get("f0"),
                    b.get("energy"), mel_mask, spk_emb=b.get("spk_emb"),
                    accent=b.get("accent"),
                    temperature=sq_temperature(state.step),
                    generator=state.generator)
        logs = {"loss_frame_before": mse_loss_arelbo(out.mel_pre, mel)}
        total = logs["loss_frame_before"]
        if out.mel_post is not None:
            logs["loss_frame_after"] = l1(out.mel_post, mel)
            total = total + logs["loss_frame_after"]
        pred_frames = (torch.exp(out.log_duration.float())
                       * src_mask[:, 0, :]).sum(1)
        mel_lengths = mel_mask[:, 0, :].sum(1).float()
        logs["loss_duration"] = (pred_frames - mel_lengths).abs().mean()
        total = total + logs["loss_duration"]
        if out.pitch is not None and b.get("f0") is not None:
            logs["loss_f0"] = l1(out.pitch, b["f0"])
            total = total + logs["loss_f0"]
        if out.energy is not None and b.get("energy") is not None:
            logs["loss_energy"] = l1(out.energy, b["energy"])
            total = total + logs["loss_energy"]
        total = total + out.sq_vae_loss
        logs["sq_vae_loss"] = out.sq_vae_loss
        logs["sq_vae_perplexity"] = out.sq_vae_perplexity
        logs["loss_total"] = total
        return _update(state, total, logs)

    return _in_contexts(step_fn)


def make_fastspeech2_eval_step(hp: HParams, *, device="cuda"):
    """``eval_fn(state, batch) -> (out, logs)``: the teacher-forced
    forward of ``state.model`` in eval mode, without gradients, on a
    collated batch (durations, f0 and energy as given; with no f0 or
    energy the model embeds its own predictions) and the FastSpeech 2
    losses of it (for a dev loss and cli/teacher_forcing.py)."""
    f0_stats = _variance_stats(hp.f0_mean, hp.f0_std)
    energy_stats = _variance_stats(hp.energy_mean, hp.energy_std)

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: Dict):
        b = batch_to(batch, device, FS2_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"])
        model = state.model
        model.eval()
        out = model(b["text"], src_mask, b["mel"].shape[1],
                    b["alignment"], b.get("f0"), b.get("energy"), mel_mask,
                    spk_emb=b.get("spk_emb"), accent=b.get("accent"),
                    hop_size=b.get("hop_size"))
        _, logs = fastspeech2_loss(
            out, b["mel"], b["alignment"], b.get("f0"), b.get("energy"),
            src_mask=src_mask, mel_mask=mel_mask, masked=False,
            log_offset=hp.log_offset, f0_stats=f0_stats,
            energy_stats=energy_stats)
        return out, logs

    return eval_fn
