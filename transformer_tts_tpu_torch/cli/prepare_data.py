"""Corpus preparation CLI: WAVs -> training features (the port of
transformer_tts_tpu/cli/prepare_data.py).

``python -m transformer_tts_tpu_torch.cli.prepare_data \\
      --wav_script wavs.txt --out_dir features/ [--sample_rate 22050]
      [--device cuda]``

``wavs.txt`` lines are ``wav_path|text_ids[|speaker[|gender]]``. For each
utterance it writes ``<stem>.npy`` (natural-log mel power, (T, n_mels)),
``<stem>_f0.npy`` (YIN f0 in Hz, 0 where unvoiced) and
``<stem>_energy.npy`` (per-frame STFT-magnitude L2 norm), T = N // hop + 1;
then ``mean.npy`` / ``var.npy`` (corpus statistics of the mels),
``lengths.npy``, ``variance_stats.json`` (f0 and energy means and
standard deviations) and the script (``--script_name``) with the mel paths
in place of the wavs. As the JAX CLI, each utterance is zero-padded to a
frame bucket of ``FRAME_BUCKETS`` and extracted alone; the features run on
the CUDA device unless ``--device cpu`` is given. Audio must be longer
than 1024 samples (YIN's reflect pad), which every bucket is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

FRAME_BUCKETS = (256, 512, 1024, 2048, 4096)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--wav_script", type=str, required=True,
                        help="lines: wav_path|text_ids[|spk[|gender]]")
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--sample_rate", type=int, default=22050)
    parser.add_argument("--n_fft", type=int, default=1024)
    parser.add_argument("--hop_length", type=int, default=256)
    parser.add_argument("--n_mels", type=int, default=80)
    parser.add_argument("--fmin", type=float, default=0.0)
    parser.add_argument("--fmax", type=float, default=None)
    parser.add_argument("--f0_min", type=float, default=71.0)
    parser.add_argument("--f0_max", type=float, default=795.8)
    parser.add_argument("--script_name", type=str,
                        default="train_script.txt")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.data.batching import pick_bucket
    from transformer_tts_tpu_torch.ops.features import (
        energy_per_frame, read_wav, yin_f0)
    from transformer_tts_tpu_torch.ops.melspectrogram import (
        log_mel_spectrogram)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to extract on the CPU)")
    os.makedirs(args.out_dir, exist_ok=True)

    @torch.no_grad()
    def extract(audio):
        mel = log_mel_spectrogram(
            audio, sample_rate=args.sample_rate, n_fft=args.n_fft,
            hop_length=args.hop_length, n_mels=args.n_mels,
            fmin=args.fmin, fmax=args.fmax)
        f0 = yin_f0(audio, sample_rate=args.sample_rate,
                    hop_length=args.hop_length, f0_min=args.f0_min,
                    f0_max=args.f0_max)
        energy = energy_per_frame(audio, n_fft=args.n_fft,
                                  hop_length=args.hop_length)
        return mel, f0, energy

    lines_out = []
    sum_mel = np.zeros((args.n_mels,), np.float64)
    sum_sq = np.zeros((args.n_mels,), np.float64)
    n_frames_total = 0
    lengths = []
    vsum = {"f0": 0.0, "f0_sq": 0.0, "energy": 0.0, "energy_sq": 0.0}

    with open(args.wav_script) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    for i, line in enumerate(lines):
        fields = line.split("|")
        wav_path = fields[0]
        audio, _ = read_wav(wav_path, expected_rate=args.sample_rate)
        n_frames = len(audio) // args.hop_length + 1
        bucket = pick_bucket(n_frames, FRAME_BUCKETS)
        n_samples = (bucket - 1) * args.hop_length
        padded = np.zeros((n_samples,), np.float32)
        padded[:len(audio)] = audio[:n_samples]
        mel, f0, energy = (x[:n_frames].float().cpu().numpy() for x in
                           extract(torch.as_tensor(padded, device=device)))

        stem = os.path.splitext(os.path.basename(wav_path))[0]
        mel_path = os.path.join(args.out_dir, f"{stem}.npy")
        np.save(mel_path, mel)
        np.save(os.path.join(args.out_dir, f"{stem}_f0.npy"), f0)
        np.save(os.path.join(args.out_dir, f"{stem}_energy.npy"), energy)
        lines_out.append("|".join([mel_path] + fields[1:]))
        sum_mel += mel.sum(axis=0)
        sum_sq += (mel.astype(np.float64) ** 2).sum(axis=0)
        vsum["f0"] += float(f0.sum())
        vsum["f0_sq"] += float((f0.astype(np.float64) ** 2).sum())
        vsum["energy"] += float(energy.sum())
        vsum["energy_sq"] += float((energy.astype(np.float64) ** 2).sum())
        n_frames_total += n_frames
        lengths.append(n_frames)
        if (i + 1) % 100 == 0 or i + 1 == len(lines):
            print(f"{i + 1}/{len(lines)} utterances", flush=True)

    mean = sum_mel / max(n_frames_total, 1)
    var = sum_sq / max(n_frames_total, 1) - mean ** 2
    np.save(os.path.join(args.out_dir, "mean.npy"),
            mean.astype(np.float32))
    np.save(os.path.join(args.out_dir, "var.npy"),
            np.maximum(var, 1e-10).astype(np.float32))
    np.save(os.path.join(args.out_dir, "lengths.npy"),
            np.asarray(lengths, np.int32))
    n = max(n_frames_total, 1)
    stats = {}
    for k in ("f0", "energy"):
        m = vsum[k] / n
        stats[f"{k}_mean"] = round(m, 4)
        stats[f"{k}_std"] = round(
            max(vsum[f"{k}_sq"] / n - m * m, 1e-10) ** 0.5, 4)
    with open(os.path.join(args.out_dir, "variance_stats.json"),
              "w") as fh:
        json.dump(stats, fh)
    print("variance stats (set f0_mean/f0_std/energy_mean/energy_std "
          f"in hparams for the standardized-predictor mode): {stats}")
    script_path = os.path.join(args.out_dir, args.script_name)
    with open(script_path, "w") as fh:
        fh.write("\n".join(lines_out) + "\n")
    print(f"wrote {len(lines_out)} utterances, {n_frames_total} frames, "
          f"script {script_path}")


if __name__ == "__main__":
    sys.exit(main())
