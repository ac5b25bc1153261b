"""Training CLI of the PyTorch port (the port of the text-mel FastSpeech 2
and AR Transformer-TTS branches of transformer_tts_tpu/cli/train.py:29-317).

``python -m transformer_tts_tpu_torch.cli.train --hp_file hparams.py
      [--set KEY=VALUE ...] [--max_steps N] [--device cuda]``

An epoch loop over the script's bucketed batches with one log line per
step (printed one step late, so the print does not hold the card back),
an assertion on a non-finite loss, a checkpoint under
``save_dir/epoch_N/`` at the epochs ``should_save`` picks (with the
optimizer at multiples of ``save_per_epoch``), a fine-tune's start from
``hp.pretrain_model`` (a port checkpoint directory: its weights and
BatchNorm statistics, loaded before any resume, as the JAX CLI's
:153-158 does), and resume from ``hp.loaded_dir``/``hp.loaded_epoch``.
Each checkpoint directory holds
``hparams.py`` and ``model.pt``, so ``cli/synthesize.py --load_name`` reads
it. ``hp.model`` picks the trainer: FastSpeech 2, or the AR
Transformer-TTS (``model = "Transformer"``). It runs on the CUDA device
unless ``--device cpu`` is given. The SQ-VAE, mel-to-mel and text-mel-mel
trainers, the AR model's later-slice options, ``--multihost`` and the
switches ``debug_nans``, ``profile_dir`` and ``tb_images`` raise
``NotImplementedError``, naming their slices.
"""

from __future__ import annotations

import argparse
import ast
import math
import sys
import time


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


def _check_branch(hp, args) -> bool:
    """Raise for a trainer of a later slice; True for the AR trainer."""
    from transformer_tts_tpu_torch.config import is_nar_model
    from transformer_tts_tpu_torch.models.fastspeech2 import later_slice
    from transformer_tts_tpu_torch.models.transformer_tts import (
        check_supported)
    if args.multihost:
        later_slice("--multihost (multi-process data parallelism)",
                    "parallelism")
    for switch in ("debug_nans", "profile_dir", "tb_images"):
        if getattr(hp, switch):
            later_slice(f"hp.{switch}", "CLIs' remaining switches")
    if hp.architecture == "mel-mel":
        later_slice("the mel-to-mel trainer", "mel-to-mel post-processing")
    if hp.architecture == "text-mel-mel":
        later_slice("the text-mel-mel integrate trainer",
                    "mel-to-mel post-processing")
    if hp.architecture != "text-mel":
        raise ValueError(f"unknown architecture {hp.architecture!r}")
    if hp.model.lower() in ("sqfastspeech2", "sq_fastspeech2",
                            "fastspeech2_sq"):
        later_slice("the SQ-VAE FastSpeech 2 trainer",
                    "other model families")
    if is_nar_model(hp.model):
        return False
    check_supported(hp)
    return True


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
    parser.add_argument("--multihost", action="store_true")
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    from transformer_tts_tpu_torch.data.loader import DataLoader
    from transformer_tts_tpu_torch.train import checkpoint as ckpt
    from transformer_tts_tpu_torch.train import trainer

    hp = load_hparams(args.hp_file).override(**_overrides(args.set))
    is_ar = _check_branch(hp, args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to train on the CPU)")
    hp.log_config()

    loader = DataLoader(TTSDataset(hp.train_script, hp), hp)
    if is_ar:
        state = trainer.init_transformer_state(hp, device=device)
        step_fn = trainer.make_transformer_train_step(hp, device=device)
    else:
        state = trainer.init_fastspeech2_state(hp, device=device)
        step_fn = trainer.make_fastspeech2_train_step(hp, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"params = {n_params / 1e6:.2f}M")

    start_epoch = 0
    if hp.pretrain_model is not None:
        ckpt.load_checkpoint(state.model, hp.pretrain_model)
        print(f"loaded pretrain params from {hp.pretrain_model}")
    if hp.loaded_epoch is not None:
        load_dir = hp.loaded_dir or hp.save_dir
        state, start_epoch = ckpt.restore_train_checkpoint(
            load_dir, state, epoch=hp.loaded_epoch)
        print(f"resumed from {load_dir} epoch {start_epoch} "
              f"(step {state.step})")

    def emit(pending):
        """Print one step's logs; the float() calls wait for the card, so
        this runs after the next step has been queued."""
        epoch, step, t0, logs = pending
        values = {k: float(v) for k, v in sorted(logs.items())}
        parts = " ".join(f"{k}={v:.4f}" for k, v in values.items())
        print(f"epoch {epoch + 1} step {step} {parts} "
              f"({time.time() - t0:.3f}s)")
        sys.stdout.flush()
        if not math.isfinite(values["loss_total"]):
            raise AssertionError("loss is nan")

    pending = None
    done = False
    for epoch in range(start_epoch, hp.max_epoch):
        t_epoch = time.time()
        for batch in loader:
            t0 = time.time()
            state, logs = step_fn(state, batch)
            if pending is not None:
                emit(pending)
            pending = ((epoch, state.step, t0, logs)
                       if state.step % hp.log_every == 0 else None)
            done = bool(args.max_steps) and state.step >= args.max_steps
            if done:
                break
        if pending is not None:
            emit(pending)
            pending = None
        if ckpt.should_save(epoch + 1, hp.max_epoch, hp.save_per_epoch):
            path = ckpt.save_train_checkpoint(
                hp.save_dir, state, epoch + 1, hp,
                with_optimizer=(epoch + 1) % hp.save_per_epoch == 0)
            print(f"saved {path}")
        print(f"epoch {epoch + 1} done in {time.time() - t_epoch:.1f}s")
        if done:
            break
    print("training finished")


if __name__ == "__main__":
    main()
