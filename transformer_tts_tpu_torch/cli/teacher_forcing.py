"""Teacher-forced mel generation of the PyTorch port (the port of
transformer_tts_tpu/cli/teacher_forcing.py): the mel-to-mel line's
pregenerated corpus.

``python -m transformer_tts_tpu_torch.cli.teacher_forcing --load_name DIR
      [--hp_file h.py] [--epoch N] [--suffix _gen] [--out_dir D]
      [--save_phone] [--variance target|predicted] [--device cuda]``

Runs the FastSpeech 2 checkpoint of ``DIR`` (resolved as in the synthesis
CLI; the hparams from ``DIR``'s parent for an ``epoch_N``/``average_N``
directory, else from ``DIR``, or ``--hp_file``) over every line of the
hparams' ``train_script``, one utterance at a time, teacher-forced with
its ground-truth durations (train/trainer.make_fastspeech2_eval_step),
and writes for each ``X.npy`` the de-normalized fp32 mel (mel_post, or
mel_pre without the postnet) cut to its frames as ``X{suffix}.npy``
beside it, or under ``--out_dir`` by its base name. ``--save_phone`` also
writes the per-frame phone feature the student reads, as
``X{suffix}_phone.npy``: ``text_dur_predicted`` at versions 4 and 6, the
variance adaptor's output at the others. ``--variance target`` feeds the
ground-truth f0 and energy; ``predicted`` drops them, so the teacher
embeds its own predictions, the distribution that synthesis serves. A
mel-mel run with ``teacher_suffix = suffix`` then trains on the corpus
(train/post_trainers.make_meltomel_pregen_train_step). It runs on the CUDA
device unless ``--device cpu`` is given, and raises when that device is
missing.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_name", type=str, required=True)
    parser.add_argument("--hp_file", type=str, default=None)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--suffix", type=str, default="_gen")
    parser.add_argument("--out_dir", type=str, default=None,
                        help="write here instead of beside the sources")
    parser.add_argument("--save_phone", action="store_true",
                        help="also save the per-frame phone features as "
                             "{stem}{suffix}_phone.npy (mel-mel students "
                             "of versions other than 1 and 5 read them)")
    parser.add_argument("--variance", choices=("target", "predicted"),
                        default="target",
                        help="pitch and energy fed to the teacher: the "
                             "ground truth, or its own predictions "
                             "(durations stay the ground truth)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import numpy as np
    import torch
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.data.batching import collate
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    from transformer_tts_tpu_torch.data.readers import Normalizer
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    from transformer_tts_tpu_torch.train.checkpoint import (
        load_checkpoint, resolve_checkpoint)
    from transformer_tts_tpu_torch.train.trainer import (
        TrainState, make_fastspeech2_eval_step)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    load_dir = os.path.normpath(args.load_name)
    hp_dir = (os.path.dirname(load_dir) if os.path.basename(
        load_dir).startswith(("epoch_", "average_")) else load_dir)
    hp = load_hparams(args.hp_file or os.path.join(hp_dir, "hparams.py"))

    model = build_fastspeech2(hp, device=device)
    load_checkpoint(model, resolve_checkpoint(args.load_name, args.epoch))
    state = TrainState(model, None, None)
    eval_fn = make_fastspeech2_eval_step(hp, device=device)
    normalizer = Normalizer(hp.mean_file, hp.var_file, hp.mel_dim)
    mean, var = normalizer.arrays()
    dataset = TTSDataset(hp.train_script, hp)
    for idx in range(len(dataset)):
        sample = dataset[idx]
        batch = collate([sample], hp)
        if args.variance == "predicted":
            batch.pop("f0", None)
            batch.pop("energy", None)
        out, _ = eval_fn(state, batch)
        n = int(batch["mel_length"][0])
        mel = (out.mel_post if out.mel_post is not None else out.mel_pre)
        mel = mel[0, :n].float().cpu().numpy()
        if mean is not None:
            mel = mel * np.sqrt(var) + mean
        src = sample["mel_name"]
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            dest = os.path.join(args.out_dir, os.path.basename(src).replace(
                ".npy", args.suffix + ".npy"))
        else:
            dest = src.replace(".npy", args.suffix + ".npy")
        np.save(dest, mel.astype(np.float32))
        if args.save_phone:
            phone = (out.text_dur_predicted if hp.version in (4, 6)
                     else out.variance_adaptor_output)
            np.save(dest.replace(".npy", "_phone.npy"),
                    phone[0, :n].float().cpu().numpy())
        print(f"save {dest}")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
