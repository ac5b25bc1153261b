"""One-command learning demonstration through the port's CLIs (the port of
egs/synthetic_overfit/run.py).

1. builds a deterministic synthetic corpus (each phone id maps to a fixed
   80-bin spectral profile, duration, f0 and energy: a language the model
   can learn exactly),
2. trains with ``cli/train`` (the real data layer, losses, bf16 autocast,
   Noam warmup and checkpoint rotation),
3. averages the last ten epochs with ``cli/average_checkpoints``,
4. synthesizes the first eight utterances with ``cli/synthesize`` from
   PREDICTED durations (FastSpeech 2) or by the KV-cached decode with the
   stop rule (``--family ar``),
5. scores mel-L1 and MCD against the ground truth with ``eval.py``,
   beside an untrained baseline of the same architecture (one step).

    python -m transformer_tts_tpu_torch.egs.synthetic_overfit
        [--family fs2|conformer|ar] [--no_flash] [--tiny] [--keep]
        [--workdir DIR] [--max_epoch N] [--device cuda]

Every CLI runs on ``--device`` (the card unless ``--device cpu``). Prints
the baseline's and the trained model's scores and one JSON summary line,
then raises ``AssertionError`` unless mel-L1 < 0.05 or the mel-L1 fell
more than 20x below the baseline's (``--tiny``: < 0.2 or 5x).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

MEL_DIM = 80
VOCAB = 40


def phone_tables(rs: np.random.RandomState):
    profiles = rs.randn(VOCAB, MEL_DIM).astype(np.float32)
    durations = (2 + np.arange(VOCAB) % 4).astype(np.int32)
    # constant f0/energy: the variance predictors converge to the exact
    # constants, so their bucketized embeddings match between
    # teacher-forced training and prediction-driven synthesis
    f0 = np.full((VOCAB,), 200.0, np.float32)
    energy = np.full((VOCAB,), 50.0, np.float32)
    return profiles, durations, f0, energy


def build_corpus(workdir: str, n_utts: int = 64, seed: int = 0,
                 min_phones: int = 6, max_phones: int = 14):
    rs = np.random.RandomState(seed)
    profiles, durs, f0s, energies = phone_tables(np.random.RandomState(7))
    lines = []
    for i in range(n_utts):
        n_phones = rs.randint(min_phones, max_phones)
        phones = rs.randint(1, VOCAB, n_phones)
        d = durs[phones]
        mel = np.repeat(profiles[phones], d, axis=0)
        f0 = np.repeat(f0s[phones], d)
        energy = np.repeat(energies[phones], d)
        base = os.path.join(workdir, f"utt{i}.npy")
        np.save(base, mel)
        np.save(os.path.join(workdir, f"utt{i}_alignment.npy"), d)
        np.save(os.path.join(workdir, f"utt{i}_f0.npy"), f0)
        np.save(os.path.join(workdir, f"utt{i}_energy.npy"), energy)
        lines.append(f"{base}|{' '.join(str(int(p)) for p in phones)}")
    with open(os.path.join(workdir, "train.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(workdir, "test.txt"), "w") as fh:
        fh.write("\n".join(lines[:8]) + "\n")


def write_hparams(workdir: str, save_dir: str, max_epoch: int,
                  extra: dict | None = None) -> str:
    cfg = dict(
        architecture="text-mel", model="Fastspeech2",
        vocab_size=VOCAB, mel_dim=MEL_DIM,
        # the flagship width (config.py's defaults)
        d_model_encoder=384, d_model_decoder=384,
        n_layer_encoder=6, n_layer_decoder=6,
        n_head_encoder=4, n_head_decoder=4,
        ff_conv_kernel_size_encoder=5, ff_conv_kernel_size_decoder=1,
        batch_size=16, max_epoch=max_epoch, save_per_epoch=max_epoch,
        warmup_step=100, warmup_factor=1.0, amp=True,
        # mel and duration only: the quantized pitch/energy embeddings of
        # a synthetic corpus add a train/synthesis mismatch that smooth
        # real contours do not have
        pitch_pred=False, energy_pred=False,
        dropout_variance_adaptor=0.1,
        train_script=os.path.join(workdir, "train.txt"),
        test_script=os.path.join(workdir, "test.txt"),
        save_dir=save_dir, log_every=20, num_workers=2,
        text_buckets=(16,), length_buckets=(64,),
    )
    cfg.update(extra or {})
    path = os.path.join(workdir, "hparams.py")
    with open(path, "w") as fh:
        fh.write("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    return path


def pad_to(ref: np.ndarray, gen: np.ndarray) -> np.ndarray:
    """``gen`` as scored against ``ref``: no frames score as silence of
    the reference's length, and missing frames as zeros, so a model that
    stops early cannot score well on a truncated L1."""
    if gen.shape[0] == 0:
        return np.zeros_like(ref)
    if gen.shape[0] < ref.shape[0]:
        return np.concatenate(
            [gen, np.zeros((ref.shape[0] - gen.shape[0], gen.shape[1]),
                           gen.dtype)])
    return gen


def score(workdir: str, gen_dir: str) -> dict:
    from transformer_tts_tpu_torch.eval import mcd, mel_l1
    with open(os.path.join(workdir, "test.txt")) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    l1s, mcds, ratios = [], [], []
    for idx, line in enumerate(lines):
        ref = np.load(line.split("|")[0])
        gen = np.load(os.path.join(gen_dir, f"{idx}.npy"))
        ratios.append(gen.shape[0] / ref.shape[0])
        gen = pad_to(ref, gen)
        l1s.append(float(mel_l1(ref, gen)))
        mcds.append(float(mcd(ref, gen)))   # DTW when the lengths differ
    return {"mel_l1": float(np.mean(l1s)), "mcd": float(np.mean(mcds)),
            "len_ratio": float(np.mean(ratios)), "n": len(lines)}


def loss_curve(save_dir: str) -> list:
    """Every tenth logged step of the training's ``train.jsonl``: the
    post-net mel loss where logged, else the total."""
    log_path = os.path.join(save_dir, "logs", "train.jsonl")
    if not os.path.exists(log_path):
        return []
    with open(log_path) as fh:
        rows = [json.loads(ln) for ln in fh if ln.strip()]
    key = ("loss_frame_after" if rows and "loss_frame_after" in rows[0]
           else "loss_total")
    return [{"step": r["step"], key: round(r.get(key, float("nan")), 4)}
            for r in rows[:: max(1, len(rows) // 10)]]


def trained_steps(save_dir: str, epoch: int) -> int:
    """The optimizer steps a training took, from its last epoch's
    ``train_state.pt``."""
    import torch
    state = torch.load(os.path.join(save_dir, f"epoch_{epoch}",
                                    "train_state.pt"),
                       map_location="cpu", weights_only=True)
    return int(state["step"])


def learned(trained: float, baseline: float, tiny: bool) -> bool:
    """The bar: mel-L1 below 0.05 or 20x under the untrained baseline's
    (``tiny``: 0.2 or 5x)."""
    if tiny:
        return trained < 0.2 or trained * 5 < baseline
    return trained < 0.05 or trained * 20 < baseline


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "tts_torch_synthetic_overfit"))
    ap.add_argument("--max_epoch", type=int, default=400)
    ap.add_argument("--family", choices=("fs2", "conformer", "ar"),
                    default="fs2",
                    help="conformer: conformer encoder and decoder on long "
                         "utterances (a 384-frame bucket, past "
                         "FLASH_MIN_KEY_LEN, so the decoder's relative "
                         "attention trains on the kernels); ar: the "
                         "autoregressive Transformer-TTS, whose KV-cached "
                         "decode must learn alignment and when to stop")
    ap.add_argument("--no_flash", action="store_true",
                    help="the masked attention path everywhere "
                         "(use_flash_attention=False): the kernels' "
                         "numerics control")
    ap.add_argument("--fp32", action="store_true",
                    help="train in fp32 (amp=False): with --no_flash the "
                         "bisection of a missed bar")
    ap.add_argument("--seed", type=int, default=None,
                    help="the hparams' seed (default: the config's): the "
                         "spread of the bar over initializations")
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir afterwards")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-budget variant (d_model 64, 2+2 layers, "
                         "relaxed bar: > 5x collapse or mel-L1 < 0.2)")
    ap.add_argument("--device", default="cuda",
                    help="the device of every CLI (cpu only when asked)")
    args = ap.parse_args(argv)

    if os.path.exists(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir)
    extra = {}
    if args.family == "conformer":
        # 72-96 phones x mean 3.5 frames -> 250-340 mel frames; the 384
        # bucket keeps every padded batch past FLASH_MIN_KEY_LEN (256)
        build_corpus(args.workdir, min_phones=72, max_phones=96)
        extra = dict(encoder_type="conformer", decoder_type="conformer",
                     batch_size=8, text_buckets=(96,),
                     length_buckets=(384,))
    elif args.family == "ar":
        build_corpus(args.workdir)
        # teacher-forced training on frame groups of 2, the weighted-BCE
        # stop loss, and a gentler warmup: the AR stack learns its
        # cross-attention alignment from scratch
        extra = dict(model="Transformer", reduction_rate=2,
                     positive_weight=5.0, warmup_step=1000)
    else:
        build_corpus(args.workdir)
    if args.tiny:
        extra.update(d_model_encoder=64, d_model_decoder=64,
                     n_layer_encoder=2, n_layer_decoder=2,
                     n_head_encoder=2, n_head_decoder=2)
    if args.no_flash:
        extra["use_flash_attention"] = False
    if args.fp32:
        extra["amp"] = False
    if args.seed is not None:
        extra["seed"] = args.seed

    from transformer_tts_tpu_torch.cli import average_checkpoints as cli_avg
    from transformer_tts_tpu_torch.cli import synthesize as cli_synth
    from transformer_tts_tpu_torch.cli import train as cli_train
    device = ["--device", args.device]

    # ---- untrained baseline: the same architecture, one optimizer step ----
    base_dir = os.path.join(args.workdir, "ckpt_baseline")
    hp0 = write_hparams(args.workdir, base_dir, max_epoch=1, extra=extra)
    cli_train.main(["--hp_file", hp0, "--max_steps", "1"] + device)
    base_gen = os.path.join(args.workdir, "gen_baseline")
    cli_synth.main(["--load_name", os.path.join(base_dir, "epoch_1"),
                    "--save", base_gen, "--batch_size", "8"] + device)
    baseline = score(args.workdir, base_gen)
    print("baseline (untrained):", json.dumps(baseline), flush=True)

    # ---- the training run ----
    save_dir = os.path.join(args.workdir, "ckpt")
    hp = write_hparams(args.workdir, save_dir, max_epoch=args.max_epoch,
                       extra=extra)
    t0 = time.perf_counter()
    cli_train.main(["--hp_file", hp] + device)
    train_seconds = time.perf_counter() - t0
    steps = trained_steps(save_dir, args.max_epoch)

    # ---- the last ten epochs averaged ----
    first = max(1, args.max_epoch - 9)
    cli_avg.main(["--save_dir", save_dir, "--start_epoch", str(first),
                  "--end_epoch", str(args.max_epoch)])
    avg_name = f"average_epoch{first}-epoch{args.max_epoch}"

    # ---- synthesis: predicted durations, or the AR decode's stop rule ----
    gen_dir = os.path.join(args.workdir, "gen")
    cli_synth.main(["--load_name", os.path.join(save_dir, avg_name),
                    "--save", gen_dir, "--batch_size", "8"] + device)
    trained = score(args.workdir, gen_dir)
    print("trained (averaged ckpt):", json.dumps(trained), flush=True)

    summary = {
        "baseline_mel_l1": round(baseline["mel_l1"], 4),
        "baseline_mcd": round(baseline["mcd"], 3),
        "trained_mel_l1": round(trained["mel_l1"], 4),
        "trained_mcd": round(trained["mcd"], 3),
        "mel_l1_collapse_x": round(baseline["mel_l1"] / trained["mel_l1"],
                                   1),
        "epochs": args.max_epoch,
        "family": args.family,
        "steps": steps,
        "train_seconds": round(train_seconds, 1),
        "steps_per_sec": round(steps / train_seconds, 2),
        "loss_curve": loss_curve(save_dir),
    }
    print(json.dumps(summary), flush=True)
    if not learned(trained["mel_l1"], baseline["mel_l1"], args.tiny):
        raise AssertionError(f"model did not learn: {summary}")
    if not args.keep:
        shutil.rmtree(args.workdir)
    return summary


if __name__ == "__main__":
    main()
