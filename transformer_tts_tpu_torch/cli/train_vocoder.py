"""Neural-vocoder training CLI (the port of
transformer_tts_tpu/cli/train_vocoder.py).

``python -m transformer_tts_tpu_torch.cli.train_vocoder --hp_file hp.py \\
      --wav_script wavs.txt [--mel_script wav_mel.txt] [--max_steps N]
      [--batch_size 16] [--save_every 5000] [--set KEY=VALUE ...]
      [--device cuda]``

``wav_script``: one wav path per line (further ``|`` fields are ignored).
The audio is read once into host memory; every step takes ``batch_size``
random crops of ``hp.vocoder_segment_size`` samples, drawn from
``hp.seed`` as the JAX CLI draws them, and runs the D-then-G GAN step of
vocoder/trainer.py, whose log-mel target is computed on the device.
``--mel_script`` (lines ``wav_path|mel.npy``) is the fine-tuning mode: the
generator vocodes the acoustic model's frame-aligned mel, the target stays
the audio's. Scalars go to ``save_dir/log_dir/train.jsonl`` and TensorBoard
events (one step late); every ``--save_every`` steps, and at the end, it
writes ``vocoder_<step>/`` (resumable with ``hp.loaded_dir`` /
``hp.loaded_epoch``) and the ``generator/`` export that
``cli/synthesize.py --vocoder`` loads. It runs on the CUDA device unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a neural vocoder")
    parser.add_argument("--hp_file", type=str, required=True)
    parser.add_argument("--wav_script", type=str, required=True)
    parser.add_argument("--mel_script", type=str, default=None,
                        help="fine-tuning mode: lines 'wav_path|mel.npy' "
                             "pair each wav with the acoustic model's "
                             "teacher-forced mel")
    parser.add_argument("--max_steps", type=int, default=100000)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--save_every", type=int, default=5000)
    parser.add_argument("--sample_rate", type=int, default=22050)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--fmin", type=float, default=0.0)
    parser.add_argument("--fmax", type=float, default=None)
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", help="hparams override")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.cli.train import _overrides
    from transformer_tts_tpu_torch.config import load_hparams
    from transformer_tts_tpu_torch.ops.features import read_wav
    from transformer_tts_tpu_torch.utils import MetricsLogger
    from transformer_tts_tpu_torch.vocoder.trainer import (
        export_generator, init_vocoder_state, make_vocoder_train_step,
        restore_vocoder_checkpoint, save_vocoder_checkpoint)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to train on the CPU)")
    hp = load_hparams(args.hp_file).override(**_overrides(args.set))
    hp.log_config()
    hp.snapshot(hp.save_dir)

    seg = hp.vocoder_segment_size
    state = init_vocoder_state(hp, seg, device=device)   # checks seg % hop
    hop = state.generator.hop_length

    # the corpus in host memory, random crops per step
    finetune = args.mel_script is not None
    script = args.mel_script if finetune else args.wav_script
    with open(script) as fh:
        entries = [ln.strip().split("|") for ln in fh if ln.strip()]
    wavs, mels = [], []
    n_frames_seg = seg // hop
    for fields in entries:
        audio, _ = read_wav(fields[0], expected_rate=args.sample_rate)
        if finetune:
            mel = np.asarray(np.load(fields[1]), np.float32)
            if mel.shape[1] != hp.mel_dim:
                raise SystemExit(f"{fields[1]}: mel_dim {mel.shape[1]} "
                                 f"!= hp.mel_dim {hp.mel_dim}")
            # frame-align: audio covers exactly n_frames * hop samples
            n = min(mel.shape[0], len(audio) // hop)
            if n < n_frames_seg:                 # tile short clips
                reps = n_frames_seg // max(n, 1) + 1
                mel = np.tile(mel[:n], (reps, 1))
                audio = np.tile(audio[:n * hop], reps)
                n = mel.shape[0]
            mels.append(mel[:n])
            audio = audio[:n * hop]
        elif len(audio) < seg:                   # tile short clips
            audio = np.tile(audio, seg // len(audio) + 1)
        wavs.append(np.asarray(audio, np.float32))
    print(f"loaded {len(wavs)} wavs "
          f"({sum(len(w) for w in wavs) / args.sample_rate:.1f}s)"
          + (" [fine-tune on predicted mels]" if finetune else ""))

    rng = np.random.RandomState(hp.seed)

    def sample_batch(bsz):
        out = np.empty((bsz, seg), np.float32)
        out_mel = (np.empty((bsz, n_frames_seg, hp.mel_dim), np.float32)
                   if finetune else None)
        for i, j in enumerate(rng.randint(0, len(wavs), size=bsz)):
            w = wavs[j]
            if finetune:
                f = rng.randint(0, mels[j].shape[0] - n_frames_seg + 1)
                out_mel[i] = mels[j][f:f + n_frames_seg]
                out[i] = w[f * hop:f * hop + seg]
            else:
                off = rng.randint(0, len(w) - seg + 1)
                out[i] = w[off:off + seg]
        return out, out_mel

    if hp.loaded_dir:
        state = restore_vocoder_checkpoint(hp.loaded_dir, state,
                                           hp.loaded_epoch)
        print(f"resumed at step {state.step}")
    mel_cfg = dict(sample_rate=args.sample_rate, n_fft=args.n_fft,
                   hop_length=hop, n_mels=hp.mel_dim, fmin=args.fmin,
                   fmax=args.fmax)
    step_fn = make_vocoder_train_step(hp, mel_cfg,
                                      predicted_mel_inputs=finetune)

    logger = MetricsLogger(os.path.join(hp.save_dir, hp.log_dir))
    t0 = time.time()
    prev = None                                  # lag prints one step
    for step in range(state.step, args.max_steps):
        audio_np, mel_np = sample_batch(args.batch_size)
        inputs = [torch.as_tensor(audio_np, device=device)]
        if finetune:
            inputs.append(torch.as_tensor(mel_np, device=device))
        scalars = step_fn(state, *inputs)
        if prev is not None and step % hp.log_every == 0:
            s = {k: float(v) for k, v in prev.items()}
            logger.log(step, **s)
            print(f"step {step} "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(s.items()))
                  + f" ({time.time() - t0:.1f}s)", flush=True)
        prev = scalars
        if (step + 1) % args.save_every == 0 or step + 1 == args.max_steps:
            save_vocoder_checkpoint(hp.save_dir, state, step + 1)
            export_generator(hp.save_dir, state)
            print(f"saved vocoder checkpoint @ step {step + 1}")
    logger.close()


if __name__ == "__main__":
    main()
