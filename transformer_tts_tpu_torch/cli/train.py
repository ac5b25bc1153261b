"""Training CLI of the PyTorch port (the port of
transformer_tts_tpu/cli/train.py:29-317).

``python -m transformer_tts_tpu_torch.cli.train --hp_file hparams.py
      [--set KEY=VALUE ...] [--max_steps N] [--device cuda]
      [--multihost [--coordinator HOST:PORT --num_processes N
                    --process_id I]]``

An epoch loop over the script's bucketed batches with one log line per
step (printed one step late, so the print does not hold the card back),
an assertion on a non-finite loss, a checkpoint under
``save_dir/epoch_N/`` at the epochs ``should_save`` picks (with the
optimizer at multiples of ``save_per_epoch``), a fine-tune's start from
``hp.pretrain_model`` (a port checkpoint directory: its weights and
BatchNorm statistics, loaded before any resume, as the JAX CLI's
:153-158 does), and resume from ``hp.loaded_dir``/``hp.loaded_epoch``.
The hparams (with the ``--set`` overrides) are written to
``save_dir/hparams.py`` at the start, and each checkpoint directory holds
its own ``hparams.py`` beside ``model.pt``, so ``cli/synthesize.py
--load_name`` reads either ``save_dir`` (with ``--epoch``) or an epoch's
directory. ``hp.model`` picks the trainer: FastSpeech 2 (with or without
``use_sq_vae``), the SQ-VAE FastSpeech 2 (``model`` one of
``SQFastSpeech2``, ``sq_fastspeech2``, ``fastspeech2_sq``), or the AR
Transformer-TTS (``model = "Transformer"``, with or without ``gst``, its
decoder a transformer stack or, with ``decoder_type = "tacotron2"``,
the Tacotron 2 decoder). ``hp.architecture`` picks the mel-to-mel line
(train/post_trainers.py): "mel-mel" trains a PostLowEnergy student of
``hp.version`` on a frozen FastSpeech 2 teacher restored from
``hp.pretrain_model`` (a port checkpoint directory, or a ``save_dir``
whose newest epoch is taken; the teacher is built from the same
hparams) or, with ``hp.teacher_suffix``, on the pregenerated corpus of
cli/teacher_forcing.py; "text-mel-mel" trains the integrate FastSpeech 2
with its post model (``hp.pretrain_model`` then starts the whole model, as
for FastSpeech 2). It runs on the CUDA device unless ``--device cpu`` is
given.

Observability and safety, as the JAX CLI (:89-92, :176-232, :243-314):
the logged steps' scalars (and steps/s) go to
``save_dir/log_dir/train.jsonl`` and TensorBoard events there;
``tb_images`` (FastSpeech 2) adds every ``save_attention_per_step`` steps
one ``collect_attn=True`` eval forward's first encoder and decoder
attention maps and the predicted and target mels as images;
``profile_dir`` traces the whole run with ``torch.profiler`` into a Chrome
trace there; SIGTERM or SIGINT stops the loop after the current step and
saves a checkpoint of that epoch with its optimizer (the preemption
checkpoint). A mel-mel step whose loss is not finite was taken with
zeroed gradients (the JAX NaN guard): the CLI prints each such step with
the total and the consecutive count and aborts with ``AssertionError``
at the 50th in a row; any other trainer asserts on its first non-finite
loss. ``debug_nans`` is the nearest counterpart of
``jax_debug_nans``: ``torch.autograd.set_detect_anomaly(True)`` for the
backward, and forward hooks on every module that raise
``FloatingPointError`` naming the first module whose output holds a NaN
or an infinity (each hook waits for the card: a debugging mode). The AR
step in the discrete mode raises ``ValueError``, as the JAX step fails
there.

``--multihost`` (the JAX CLI's :38-67, :100-107, :166-170, :278,
:296-307) trains data-parallel, one process per card: under ``torchrun
--nproc_per_node=N`` from its environment, or with ``--coordinator``,
``--num_processes`` and ``--process_id`` given to each process. Each rank
runs on ``cuda:LOCAL_RANK`` (gloo on the CPU with ``--device cpu``, NCCL
on the card), reads its shard of every epoch's batches padded to one
shape, and steps through DDP (train/trainer.py ``distribute``); rank 0
alone prints the logs, writes the metrics, TensorBoard, the profile and
the checkpoints, and every rank waits at a barrier before a resume and at
the exit. The ranks agree on the step to stop at after a SIGTERM through
an all-reduced flag on a gloo group of the CPU (no wait for the card),
since a rank that stopped alone would leave DDP's next all-reduce
hanging.
"""

from __future__ import annotations

import argparse
import ast
import math
import os
import signal
import sys
import time
from contextlib import contextmanager, nullcontext


def _overrides(pairs) -> dict:
    """{key: value} of ``--set KEY=VALUE`` arguments, values parsed as
    Python literals where they are one."""
    out = {}
    for kv in pairs:
        key, _, value = kv.partition("=")
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
        out[key] = value
    return out


NAN_ABORT = 50              # consecutive non-finite mel-mel steps


def _check_branch(hp, args) -> str:
    """The trainer's kind: "melmel", "pregen", "integrate", "sq",
    "fastspeech2" or "ar"."""
    from transformer_tts_tpu_torch.config import is_nar_model, is_sq_model
    from transformer_tts_tpu_torch.models.transformer_tts import (
        check_supported)
    if hp.architecture == "mel-mel":
        if hp.teacher_suffix:
            return "pregen"
        if hp.pretrain_model is None:
            raise ValueError(
                "mel-mel training needs hp.pretrain_model (the frozen "
                "teacher) or hp.teacher_suffix (a pregenerated corpus)")
        return "melmel"
    if hp.architecture == "text-mel-mel":
        return "integrate"
    if hp.architecture != "text-mel":
        raise ValueError(f"unknown architecture {hp.architecture!r}")
    if is_sq_model(hp.model):
        return "sq"
    if is_nar_model(hp.model):
        return "fastspeech2"
    check_supported(hp)
    return "ar"


def _tensors(value):
    """The tensors of a module's output (nested tuples, lists, dicts)."""
    import torch
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, (tuple, list)):
        for x in value:
            yield from _tensors(x)
    elif isinstance(value, dict):
        for x in value.values():
            yield from _tensors(x)


@contextmanager
def debug_nans(model):
    """Anomaly detection for the backward and a forward hook on every
    module of ``model`` that raises ``FloatingPointError`` naming the
    first module (in the order they finish) whose output holds a NaN or
    an infinity; both undone on exit."""
    import torch

    def hook_for(name):
        def hook(module, inputs, output):
            for t in _tensors(output):
                if t.is_floating_point() and not bool(
                        torch.isfinite(t).all()):
                    raise FloatingPointError(
                        f"non-finite output of module "
                        f"{name or '<model>'} ({type(module).__name__})")
        return hook

    handles = [m.register_forward_hook(hook_for(n))
               for n, m in model.named_modules()]
    was_on = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(was_on)
        for h in handles:
            h.remove()


@contextmanager
def preemption_guard():
    """{"stop": bool} set by SIGTERM or SIGINT while the block runs; the
    previous handlers come back on exit."""
    flag = {"stop": False}

    def request_stop(signum, frame):
        print(f"signal {signum}: checkpointing and stopping...")
        flag["stop"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, request_stop)
        except ValueError:          # not the main thread
            pass
    try:
        yield flag
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def make_image_dump(hp, device, metrics):
    """``dump(step, state, batch)``: one ``collect_attn=True`` eval forward
    of the FastSpeech 2 model on the batch, teacher-forced as in training,
    logging the first layer's first head of the encoder and decoder
    attention and the predicted and target mels of the first row as
    TensorBoard images (JAX CLI :182-215)."""
    import torch
    from transformer_tts_tpu_torch.ops.masks import create_masks
    from transformer_tts_tpu_torch.train.trainer import (
        FS2_BATCH_KEYS, batch_to)

    def image(x):
        return x.detach().float().cpu().numpy()

    def dump(step, state, batch):
        b = batch_to(batch, device, FS2_BATCH_KEYS)
        src_mask, mel_mask = create_masks(b["pos_text"], b["pos_mel"],
                                          fix_mask=hp.fix_mask)
        model = state.model
        model.eval()
        try:
            with torch.no_grad():
                out = model(b["text"], src_mask, b["mel"].shape[1],
                            b["alignment"], b.get("f0"), b.get("energy"),
                            mel_mask, collect_attn=True)
        finally:
            model.train()
        mel = out.mel_post if out.mel_post is not None else out.mel_pre
        metrics.log_image(step, "attention/encoder_l0_h0",
                          image(out.attn_enc[0, 0, 0]))
        metrics.log_image(step, "attention/decoder_l0_h0",
                          image(out.attn_dec[0, 0, 0]))
        metrics.log_image(step, "mel/predicted", image(mel[0].T))
        metrics.log_image(step, "mel/target", image(b["mel"][0].T))

    return dump


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train FastSpeech 2 or the AR Transformer-TTS "
                    "(PyTorch port)")
    parser.add_argument("--hp_file", type=str, required=True)
    parser.add_argument("--max_steps", type=int, default=None,
                        help="stop after N steps")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", help="hparams override")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--multihost", action="store_true",
                        help="data-parallel training, one process per card "
                             "(torchrun, or the three flags below)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rank 0's host:port (default: torchrun's "
                             "MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.parallel import mesh

    hp = load_hparams(args.hp_file).override(**_overrides(args.set))
    kind = _check_branch(hp, args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to train on the CPU)")
    if args.multihost:
        device = mesh.init_distributed(args.coordinator, args.num_processes,
                                       args.process_id, device=device.type)
    rank, world = mesh.process_index(), mesh.process_count()
    try:
        _train(hp, args, kind, device, rank, world)
    finally:
        if args.multihost:
            torch.distributed.destroy_process_group()


def _train(hp, args, kind, device, rank, world):
    """Everything after the process group: the state, the loop, the
    logs (rank 0's)."""
    import torch
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    from transformer_tts_tpu_torch.data.loader import DataLoader
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    from transformer_tts_tpu_torch.train import post_trainers as post
    from transformer_tts_tpu_torch.train import trainer
    if rank == 0:
        hp.log_config()
        hp.snapshot(hp.save_dir)
    loader = DataLoader(TTSDataset(hp.train_script, hp), hp,
                        num_workers=hp.num_workers, shard=rank,
                        num_shards=world)
    if kind == "melmel":
        state = post.init_post_state(hp, device=device)
        step_fn = post.make_meltomel_train_step(
            _teacher(hp, device), hp, device=device)
    else:
        init, make_step = {
            "ar": (trainer.init_transformer_state,
                   trainer.make_transformer_train_step),
            "sq": (trainer.init_sq_fastspeech2_state,
                   trainer.make_sq_fastspeech2_train_step),
            "pregen": (post.init_post_state,
                       post.make_meltomel_pregen_train_step),
            "integrate": (trainer.init_fastspeech2_state,
                          post.make_integrate_train_step),
            "fastspeech2": (trainer.init_fastspeech2_state,
                            trainer.make_fastspeech2_train_step)}[kind]
        state = init(hp, device=device)
        step_fn = make_step(hp, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    if rank == 0:
        print(f"params = {n_params / 1e6:.2f}M")

    start_epoch = 0
    if hp.pretrain_model is not None and kind != "melmel":
        ckpt.load_checkpoint(state.model, hp.pretrain_model)
        print(f"loaded pretrain params from {hp.pretrain_model}")
    if hp.loaded_epoch is not None:
        load_dir = hp.loaded_dir or hp.save_dir
        state, start_epoch = ckpt.restore_train_checkpoint(
            load_dir, state, epoch=hp.loaded_epoch)
        if rank == 0:
            print(f"resumed from {load_dir} epoch {start_epoch} "
                  f"(step {state.step})")
    if args.multihost:
        state = trainer.distribute(state, device)
        if rank == 0:
            print(f"data parallel over {world} processes "
                  f"({torch.distributed.get_backend()})")

    from transformer_tts_tpu_torch.utils import (
        MetricsLogger, StepTimer, start_profiler, stop_profiler)
    metrics = (MetricsLogger(os.path.join(hp.save_dir, hp.log_dir))
               if rank == 0 else None)
    timer = StepTimer()
    dump_images = (make_image_dump(hp, device, metrics)
                   if hp.tb_images and kind == "fastspeech2" and rank == 0
                   else None)

    nan_skips = {"total": 0, "consecutive": 0}

    def emit(pending):
        """Print and record one step's logs (rank 0) and check the loss
        (every rank: the logs are the global batch's); the float() calls
        wait for the card, so this runs after the next step has been
        queued."""
        epoch, step, t0, logs = pending
        values = {k: float(v) for k, v in sorted(logs.items())}
        if metrics is not None:
            parts = " ".join(f"{k}={v:.4f}" for k, v in values.items())
            print(f"epoch {epoch + 1} step {step} {parts} "
                  f"({time.time() - t0:.3f}s)")
            sys.stdout.flush()
            metrics.log(step, steps_per_sec=timer.steps_per_sec, **values)
        if math.isfinite(values["loss_total"]):
            nan_skips["consecutive"] = 0
            return
        if hp.architecture != "mel-mel":
            raise AssertionError("loss is nan")
        nan_skips["total"] += 1
        nan_skips["consecutive"] += 1
        if metrics is not None:
            print(f"skipped NaN step ({nan_skips['total']} total, "
                  f"{nan_skips['consecutive']} consecutive)")
        if nan_skips["consecutive"] >= NAN_ABORT:
            raise AssertionError(
                f"{nan_skips['consecutive']} consecutive NaN steps: the run "
                "is permanently non-finite")

    with (debug_nans(state.model) if hp.debug_nans else nullcontext()), \
            preemption_guard() as preempted:
        prof = (start_profiler(hp.profile_dir)
                if hp.profile_dir and rank == 0 else None)
        try:
            _epochs(hp, args, loader, state, step_fn, start_epoch, emit,
                    timer, dump_images, stop_agreement(preempted, world))
        finally:
            if prof is not None:
                path = stop_profiler(prof, hp.profile_dir)
                print(f"profile written to {path}")
            if metrics is not None:
                metrics.close()
            if world > 1:
                ckpt.barrier()
    if rank == 0:
        print("training finished")


def _teacher(hp, device):
    """The mel-mel step's frozen FastSpeech 2: built from ``hp`` and
    restored, weights and BatchNorm statistics, from
    ``hp.pretrain_model``."""
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.train.checkpoint import (
        load_checkpoint, resolve_checkpoint)
    teacher = build_fastspeech2(hp, device=device)
    load_checkpoint(teacher, resolve_checkpoint(hp.pretrain_model))
    print(f"loaded the frozen teacher from {hp.pretrain_model}")
    return teacher.eval()


def stop_agreement(preempted: dict, world: int):
    """``stop()``: whether to stop after this step. With more than one
    process, every rank's flag is all-reduced (max) on a gloo group of
    the CPU, so all stop at the same step and none waits for the card."""
    if world == 1:
        return lambda: preempted["stop"]
    import torch
    import torch.distributed as dist
    group = dist.new_group(backend="gloo")

    def stop() -> bool:
        flag = torch.tensor([1 if preempted["stop"] else 0])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())
    return stop


def _epochs(hp, args, loader, state, step_fn, start_epoch, emit, timer,
            dump_images, stop):
    """The epoch loop: steps, one-step-lagged logs, images, the epoch's
    checkpoint, and the preemption checkpoint when a signal came."""
    from transformer_tts_tpu_torch.parallel.mesh import check_local_batch
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    pending = None
    done = False
    stopping = False
    first = True
    for epoch in range(start_epoch, hp.max_epoch):
        t_epoch = time.time()
        for batch in loader:
            t0 = time.time()
            if first and state.ddp is not None:
                check_local_batch(batch)
                first = False
            state, logs = step_fn(state, batch)
            timer.tick()
            if (dump_images is not None
                    and state.step % hp.save_attention_per_step == 0):
                dump_images(state.step, state, batch)
            if pending is not None:
                emit(pending)
            pending = ((epoch, state.step, t0, logs)
                       if state.step % hp.log_every == 0 else None)
            done = bool(args.max_steps) and state.step >= args.max_steps
            stopping = stop()
            if done or stopping:
                break
        if pending is not None:
            emit(pending)
            pending = None
        writer = ckpt.is_writer()
        if ckpt.should_save(epoch + 1, hp.max_epoch, hp.save_per_epoch):
            path = ckpt.save_train_checkpoint(
                hp.save_dir, state, epoch + 1, hp,
                with_optimizer=(epoch + 1) % hp.save_per_epoch == 0)
            if writer:
                print(f"saved {path}")
        if writer:
            print(f"epoch {epoch + 1} done in {time.time() - t_epoch:.1f}s")
        if stopping:
            ckpt.save_train_checkpoint(hp.save_dir, state, epoch + 1, hp)
            if writer:
                print(f"preemption checkpoint saved at epoch {epoch + 1} "
                      f"(step {state.step})")
            break
        if done:
            break


if __name__ == "__main__":
    main()
