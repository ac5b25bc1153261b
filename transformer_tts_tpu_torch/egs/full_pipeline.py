"""One-command full pipeline through the port's CLIs, raw WAVs to a
speaking model (the port of egs/full_pipeline/run.py).

1. builds a deterministic synthetic audio language (each phone id a fixed
   harmonic tone with a glide, an envelope and a fixed duration) and
   writes 16-bit WAVs and the ``wav|text_ids`` script,
2. ``cli/prepare_data``: log-mel, YIN f0 and energy on the device, the
   corpus statistics and the lengths,
3. durations: by construction (``--durations known``, the default) or
   from an AR Transformer-TTS teacher (``--durations teacher``: trained
   with ``cli/train``, scored by free-running stop-token synthesis, then
   ``cli/extract_durations`` from its cross-attention),
4. ``cli/train``: FastSpeech 2 on the extracted features (pitch and
   energy predictors on, in standardized units, unless ``--no-variance``),
   then ``cli/average_checkpoints``,
5. ``cli/train_vocoder``: a GAN vocoder on the same WAVs (the iSTFT
   family, or ``--vocoder-family hifigan``),
6. ``cli/synthesize --vocoder``: text to mel to waveform from predicted
   durations,
7. scores in the audio domain: the synthesized and the ground-truth WAVs
   re-analyzed by the same featurizer (mel-L1 with padding, MCD with
   DTW) beside an untrained acoustic model through the same vocoder, and
   the vocoder's own copy-synthesis floor (ground-truth mel to audio
   against the ground-truth audio).

    python -m transformer_tts_tpu_torch.egs.full_pipeline
        [--workdir DIR] [--max_epoch N] [--voc_steps N]
        [--durations known|teacher] [--ar_epochs N]
        [--vocoder-family istft|hifigan] [--no-variance] [--tiny] [--keep]
        [--device cuda]

Every CLI runs on ``--device`` (the card unless ``--device cpu``). Prints
one JSON summary line, then raises ``AssertionError`` unless (a) the
acoustic model's mel error fell against the baseline's and (b) the
pipeline's audio-domain mel-L1 came within reach of the vocoder's floor
(the bars of ``main``). ``--post`` and ``--post_variance`` (the mel-to-mel
student) are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import wave

import numpy as np

from transformer_tts_tpu_torch.egs.synthetic_overfit import pad_to

MEL_DIM = 80
VOCAB = 24
SR = 8000
HOP = 128
N_FFT = 512
MEL_CFG = dict(sample_rate=SR, n_fft=N_FFT, hop_length=HOP,
               n_mels=MEL_DIM)


def phone_wave(p: int, n_frames: int) -> np.ndarray:
    """A deterministic broadband harmonic tone for phone id ``p`` with
    structure inside the phone: 12 harmonics with phone-specific
    amplitudes up to ~3.6 kHz (the phone shows in almost every mel bin),
    an exponential f0 glide of -5..+5 semitones (not 0) across the phone,
    and a triangular amplitude envelope (0.35 -> 1.0 -> 0.35) whose peak
    is phone-specific. The glide and the envelope make frame t a function
    of the position inside the phone, which an AR decoder can only follow
    by tracking the text."""
    f0 = 110.0 * 2.0 ** (p / 16.0)               # 110..297 Hz at onset
    glide = (p * 5) % 11 - 5                     # -5..+5 semitones
    if glide == 0:
        glide = 3
    ratio = 2.0 ** (glide / 12.0)
    n = n_frames * HOP
    t = np.arange(n) / SR
    dur = n / SR
    # exponential chirp: f(t) = f0 * ratio**(t/dur);
    # phase(t) = 2*pi * f0 * dur * (ratio**(t/dur) - 1) / ln(ratio)
    phase = (2 * np.pi * f0 * dur
             * (ratio ** (t / dur) - 1.0) / np.log(ratio))
    x = np.zeros(n)
    f_max = f0 * max(ratio, 1.0)
    for k in range(1, 13):
        if k * f_max >= SR / 2 * 0.95:
            break
        a = (((p * k * 7) % 9) + 1) / 9.0 * 0.8 ** (k - 1)
        x += a * np.sin(k * phase)
    x *= 0.5 / max(np.abs(x).max(), 1e-6)
    # triangular amplitude envelope, phone-specific peak position
    peak = (0.2 + 0.6 * ((p * 3) % 7) / 6.0) * dur
    env = np.where(t <= peak,
                   0.35 + 0.65 * t / max(peak, 1e-6),
                   1.0 - 0.65 * (t - peak) / max(dur - peak, 1e-6))
    ramp = min(40, n // 4)                        # 5 ms edge fades
    env[:ramp] *= np.linspace(0, 1, ramp)
    env[-ramp:] *= np.linspace(1, 0, ramp)
    return (x * env).astype(np.float32)


def phone_duration(p: int) -> int:
    return 3 + p % 4                              # 3..6 frames


def build_audio_corpus(workdir: str, n_utts: int = 64, seed: int = 0,
                       min_phones: int = 6, max_phones: int = 14,
                       duration_jitter: int = 0):
    """Writes ``wavs/utt<i>.wav``, ``wavs.txt`` and ``wav_paths.txt``;
    returns each utterance's true durations by stem. ``duration_jitter``
    adds a +-jitter to each occurrence's duration (off by default: a
    duration predictor cannot predict it from the text)."""
    rs = np.random.RandomState(seed)
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    lines, durations = [], {}
    for i in range(n_utts):
        phones = rs.randint(1, VOCAB, rs.randint(min_phones, max_phones))
        d = np.asarray([phone_duration(int(p)) for p in phones], np.int32)
        if duration_jitter:
            d = np.maximum(
                d + rs.randint(-duration_jitter, duration_jitter + 1,
                               size=d.shape), 2).astype(np.int32)
        audio = np.concatenate([phone_wave(int(p), int(di))
                                for p, di in zip(phones, d)])
        path = os.path.join(wav_dir, f"utt{i}.wav")
        with wave.open(path, "wb") as fh:
            fh.setnchannels(1)
            fh.setsampwidth(2)
            fh.setframerate(SR)
            fh.writeframes(np.clip(audio * 32767, -32767, 32767)
                           .astype(np.int16).tobytes())
        # centred framing: the extractor gives sum(d) + 1 frames; the last
        # phone takes the extra frame so the durations sum to the mel's
        d[-1] += 1
        durations[f"utt{i}"] = d
        lines.append(f"{path}|{' '.join(str(int(p)) for p in phones)}")
    with open(os.path.join(workdir, "wavs.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(workdir, "wav_paths.txt"), "w") as fh:
        fh.write("\n".join(ln.split("|")[0] for ln in lines) + "\n")
    return durations


def write_acoustic_hparams(workdir: str, feat_dir: str, save_dir: str,
                           max_epoch: int, extra: dict | None = None,
                           name: str = "hparams.py"):
    cfg = dict(
        architecture="text-mel", model="Fastspeech2",
        vocab_size=VOCAB, mel_dim=MEL_DIM,
        d_model_encoder=384, d_model_decoder=384,
        n_layer_encoder=6, n_layer_decoder=6,
        n_head_encoder=4, n_head_decoder=4,
        ff_conv_kernel_size_encoder=5, ff_conv_kernel_size_decoder=1,
        batch_size=16, max_epoch=max_epoch, save_per_epoch=max_epoch,
        warmup_step=100, warmup_factor=1.0, amp=True,
        # pitch and energy prediction: main() turns them on with the
        # corpus's f0/energy means and deviations from prepare_data's
        # variance_stats.json (standardized units keep every loss term
        # O(1)); --no-variance keeps the duration-only adaptor
        pitch_pred=False, energy_pred=False,
        f0_min=71.0, f0_max=500.0,
        dropout_variance_adaptor=0.1,
        train_script=os.path.join(feat_dir, "train.txt"),
        test_script=os.path.join(feat_dir, "test.txt"),
        mean_file=os.path.join(feat_dir, "mean.npy"),
        var_file=os.path.join(feat_dir, "var.npy"),
        lengths_file=os.path.join(feat_dir, "lengths.npy"),
        save_dir=save_dir, log_every=20, num_workers=2,
        text_buckets=(16,), length_buckets=(96,),
        # the vocoder's architecture rides in the acoustic hparams, so
        # synthesize --vocoder builds the matching generator
        vocoder_type="istft",
        vocoder_upsample_rates=(8, 4, 4),        # hop 128
        vocoder_upsample_kernel_sizes=(16, 8, 8),
        vocoder_istft_n_fft=N_FFT,
        vocoder_convnext_channels=256,
        vocoder_convnext_layers=4,
        vocoder_convnext_mlp=768,
        vocoder_channels=128,
        vocoder_resblock_kernel_sizes=(3, 7),
        vocoder_resblock_dilations=((1, 3, 5), (1, 3, 5)),
        vocoder_periods=(2, 3, 5), vocoder_num_scales=2,
        vocoder_segment_size=2048,               # 16 frames
    )
    cfg.update(extra or {})
    path = os.path.join(workdir, name)
    with open(path, "w") as fh:
        fh.write("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    return path, cfg


def split_scripts(feat_dir: str, n_test: int = 8):
    with open(os.path.join(feat_dir, "train_script.txt")) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()]
    with open(os.path.join(feat_dir, "train.txt"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(feat_dir, "test.txt"), "w") as fh:
        fh.write("\n".join(lines[:n_test]) + "\n")
    return lines


def mel_scores(gen_dir: str, feat_dir: str, n_test: int = 8) -> dict:
    """The synthesized de-normalized log-mels against the extracted
    ground-truth mels, with padding: the acoustic model's learning,
    whatever the vocoder's quality."""
    from transformer_tts_tpu_torch.eval import mel_l1
    l1s = []
    for idx in range(n_test):
        ref = np.load(os.path.join(feat_dir, f"utt{idx}.npy"))
        gen = pad_to(ref, np.load(os.path.join(gen_dir, f"{idx}.npy")))
        l1s.append(float(mel_l1(ref, gen)))
    return {"mel_l1": float(np.mean(l1s)), "n": n_test}


def log_mel(audio: np.ndarray, device: str) -> np.ndarray:
    import torch
    from transformer_tts_tpu_torch.ops.melspectrogram import (
        log_mel_spectrogram)
    with torch.no_grad():
        mel = log_mel_spectrogram(torch.as_tensor(audio, device=device),
                                  **MEL_CFG)
    return mel.cpu().numpy().astype(np.float32)


def audio_scores(gen_dir: str, feat_dir: str, workdir: str,
                 n_test: int = 8, device: str = "cuda") -> dict:
    """The synthesized and the ground-truth WAVs re-analyzed by the same
    featurizer on ``device``: mel-L1 with padding, MCD (DTW where the
    lengths differ); a missing WAV scores as silence."""
    from transformer_tts_tpu_torch.eval import mcd, mel_l1
    from transformer_tts_tpu_torch.ops.features import read_wav

    def logmel(path):
        return log_mel(read_wav(path, expected_rate=SR)[0], device)

    l1s, mcds = [], []
    for idx in range(n_test):
        ref = logmel(os.path.join(workdir, "wavs", f"utt{idx}.wav"))
        gen_path = os.path.join(gen_dir, f"{idx}.wav")
        gen = (logmel(gen_path) if os.path.exists(gen_path)
               else np.zeros_like(ref))
        gen = pad_to(ref, gen)
        l1s.append(float(mel_l1(ref, gen)))
        mcds.append(float(mcd(ref, gen)))
    return {"mel_l1": float(np.mean(l1s)), "mcd": float(np.mean(mcds)),
            "n": n_test}


def copy_synthesis_score(voc_dir: str, cfg: dict, feat_dir: str,
                         workdir: str, n_test: int = 8,
                         device: str = "cuda") -> dict:
    """Ground-truth mels vocoded and compared to the ground-truth audio:
    the vocoder's own quality, whatever the acoustic model's."""
    import torch
    from transformer_tts_tpu_torch.config import HParams
    from transformer_tts_tpu_torch.eval import mel_l1
    from transformer_tts_tpu_torch.ops.features import read_wav
    from transformer_tts_tpu_torch.vocoder.trainer import (
        build_vocoder, restore_generator_params)

    gen = build_vocoder(HParams(**cfg), amp=False, device=device)
    gen.load_state_dict(restore_generator_params(voc_dir, device))
    gen.eval()
    l1s = []
    bucket = 96                                   # one shape for every call
    for idx in range(n_test):
        mel = np.load(os.path.join(feat_dir, f"utt{idx}.npy"))
        n = mel.shape[0]
        mel_pad = np.zeros((1, bucket, mel.shape[1]), np.float32)
        mel_pad[0, :n] = mel
        with torch.no_grad():
            wav = gen(torch.as_tensor(mel_pad, device=device))[0, : n * HOP]
        remel = log_mel(wav.float().cpu().numpy(), device)
        audio, _ = read_wav(os.path.join(workdir, "wavs", f"utt{idx}.wav"),
                            expected_rate=SR)
        ref = log_mel(audio, device)
        n = min(remel.shape[0], ref.shape[0])
        l1s.append(float(mel_l1(ref[:n], remel[:n])))
    return {"copy_synthesis_mel_l1": float(np.mean(l1s)), "n": n_test}


def teacher_durations(workdir: str, feat_dir: str, lines, tiny_extra,
                      ar_epochs: int = 400, device: str = "cuda"):
    """``--durations teacher``: the AR teacher trained, its cross-attention
    turned into durations (cli/extract_durations.py), and its own scores:

    * ``ar_train_loss_first/last``: the post-net mel L1 over training
      (the trainer's JSONL curve),
    * ``ar_mel_l1``, ``ar_mcd_dtw``: free-running stop-token synthesis of
      the test set against the ground-truth mels,
    * ``ar_len_err_*``: the stop rule's length against the ground truth's,
    * ``ar_focus/monotonicity/coverage``: the extraction attention's
      quality (``attention_quality``).
    """
    from transformer_tts_tpu_torch.cli import extract_durations as cli_ext
    from transformer_tts_tpu_torch.cli import synthesize as cli_synth
    from transformer_tts_tpu_torch.cli import train as cli_train
    from transformer_tts_tpu_torch.eval import mcd
    ar_dir = os.path.join(workdir, "ckpt_ar")
    cfg = dict(
        # reduction_rate 1: the free-running decode follows the corpus far
        # better feeding back the true previous frame, and the alignment
        # resolves single frames
        architecture="text-mel", model="Transformer", reduction_rate=1,
        vocab_size=VOCAB, mel_dim=MEL_DIM,
        d_model_encoder=384, d_model_decoder=384,
        n_layer_encoder=6, n_layer_decoder=6,
        n_head_encoder=4, n_head_decoder=4,
        ff_conv_kernel_size_encoder=5, ff_conv_kernel_size_decoder=1,
        batch_size=16, max_epoch=ar_epochs, save_per_epoch=ar_epochs,
        warmup_step=1000, warmup_factor=1.0, amp=True,
        positive_weight=5.0,
        # the diagonal attention prior: teacher-forced training on this
        # corpus localizes nothing without it (the input frame leaks the
        # position inside the phone)
        guided_attention_weight=2.0,
        train_script=os.path.join(feat_dir, "train.txt"),
        test_script=os.path.join(feat_dir, "test.txt"),
        mean_file=os.path.join(feat_dir, "mean.npy"),
        var_file=os.path.join(feat_dir, "var.npy"),
        lengths_file=os.path.join(feat_dir, "lengths.npy"),
        save_dir=ar_dir, log_every=50, num_workers=2,
        text_buckets=(16,), length_buckets=(96,),
    )
    cfg.update(tiny_extra or {})
    hp_path = os.path.join(workdir, "hparams_ar.py")
    with open(hp_path, "w") as fh:
        fh.write("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    dev = ["--device", device]
    cli_train.main(["--hp_file", hp_path] + dev)
    stats_file = os.path.join(workdir, "duration_stats.json")
    cli_ext.main(["--load_name", ar_dir,        # the newest epoch
                  "--script", os.path.join(feat_dir, "train.txt"),
                  "--stats_file", stats_file] + dev)

    # free-running AR synthesis with the stop rule
    ar_gen = os.path.join(workdir, "gen_ar")
    cli_synth.main(["--load_name", ar_dir, "--save", ar_gen,
                    "--batch_size", "8"] + dev)
    ar_mel = mel_scores(ar_gen, feat_dir)
    len_errs, mcds = [], []
    for idx in range(8):
        ref = np.load(os.path.join(feat_dir, f"utt{idx}.npy"))
        gen = np.load(os.path.join(ar_gen, f"{idx}.npy"))
        len_errs.append(abs(gen.shape[0] / ref.shape[0] - 1.0))
        if gen.shape[0]:
            # DTW MCD: the content under the decode's timing drift
            mcds.append(mcd(ref, gen, use_dtw=True))
    recs = read_log(ar_dir)
    first = float(np.mean([r["loss_frame_after"] for r in recs[:5]]))
    last = float(np.mean([r["loss_frame_after"] for r in recs[-5:]]))
    with open(stats_file) as fh:
        align = json.load(fh)
    return {
        "ar_train_loss_first": round(first, 4),
        "ar_train_loss_last": round(last, 4),
        "ar_mel_l1": round(ar_mel["mel_l1"], 4),
        "ar_mcd_dtw": round(float(np.mean(mcds)), 3) if mcds else None,
        "ar_len_err_mean": round(float(np.mean(len_errs)), 4),
        "ar_len_err_max": round(float(np.max(len_errs)), 4),
        "ar_focus": round(align["focus"], 4),
        "ar_monotonicity": round(align["monotonicity"], 4),
        "ar_coverage": round(align["coverage"], 4),
    }


def read_log(save_dir: str) -> list:
    with open(os.path.join(save_dir, "logs", "train.jsonl")) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def check(ok: bool, what: str, values: dict):
    if not ok:
        raise AssertionError(f"{what}: {values}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "tts_torch_full_pipeline"))
    ap.add_argument("--max_epoch", type=int, default=600)
    ap.add_argument("--voc_steps", type=int, default=2000)
    ap.add_argument("--durations", choices=("known", "teacher"),
                    default="known")
    ap.add_argument("--ar_epochs", type=int, default=400,
                    help="AR teacher epochs for --durations teacher")
    ap.add_argument("--vocoder-family", choices=("istft", "hifigan"),
                    default="istft", dest="vocoder_family")
    ap.add_argument("--post", action="store_true",
                    help="the mel-to-mel student (not ported yet)")
    ap.add_argument("--post_variance", choices=("target", "predicted"),
                    default=None,
                    help="the student corpus's variance (not ported yet)")
    ap.add_argument("--no-variance", action="store_true",
                    dest="no_variance",
                    help="duration-only variance adaptor; the default "
                         "trains the pitch and energy predictors in "
                         "standardized units")
    ap.add_argument("--fp32", action="store_true",
                    help="train the acoustic model and the AR teacher in "
                         "fp32 (amp=False): the bisection of a missed bar")
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="CPU-budget variant (d_model 64, 2+2 layers, a "
                         "tiny vocoder, relaxed bars: > 1.5x collapse or "
                         "mel-L1 < 2.0, and within 1.5 of the vocoder's "
                         "floor)")
    ap.add_argument("--device", default="cuda",
                    help="the device of every CLI (cpu only when asked)")
    args = ap.parse_args(argv)
    if args.post or args.post_variance is not None:
        raise NotImplementedError(
            "--post/--post_variance (the mel-to-mel student scored in and "
            "out of its distribution) are not ported yet: ROADMAP.md, "
            "Queue 1")

    if args.tiny:
        args.max_epoch = min(args.max_epoch, 150)
        args.voc_steps = min(args.voc_steps, 500)

    if os.path.exists(args.workdir):
        shutil.rmtree(args.workdir)
    os.makedirs(args.workdir)

    from transformer_tts_tpu_torch.cli import average_checkpoints as cli_avg
    from transformer_tts_tpu_torch.cli import prepare_data as cli_prep
    from transformer_tts_tpu_torch.cli import synthesize as cli_synth
    from transformer_tts_tpu_torch.cli import train as cli_train
    from transformer_tts_tpu_torch.cli import train_vocoder as cli_voc
    dev = ["--device", args.device]

    # ---- 1+2: the audio corpus and its features ----
    durations = build_audio_corpus(args.workdir)
    feat_dir = os.path.join(args.workdir, "feats")
    cli_prep.main(["--wav_script", os.path.join(args.workdir, "wavs.txt"),
                   "--out_dir", feat_dir,
                   "--sample_rate", str(SR), "--n_fft", str(N_FFT),
                   "--hop_length", str(HOP), "--n_mels", str(MEL_DIM),
                   "--f0_min", "71.0", "--f0_max", "500.0"] + dev)
    lines = split_scripts(feat_dir)

    extra = {}
    if not args.no_variance:
        with open(os.path.join(feat_dir, "variance_stats.json")) as fh:
            vstats = json.load(fh)
        # scheduled sampling: the decoder sometimes trains on PREDICTED
        # pitch/energy embeddings, so the within-phone glides that the
        # phone-constant predictors cannot express do not put synthesis
        # off the training manifold
        extra.update(pitch_pred=True, energy_pred=True,
                     p_scheduled_sampling=0.5,
                     f0_mean=vstats["f0_mean"], f0_std=vstats["f0_std"],
                     energy_mean=vstats["energy_mean"],
                     energy_std=vstats["energy_std"])
    if args.tiny:
        extra.update(d_model_encoder=64, d_model_decoder=64,
                     n_layer_encoder=2, n_layer_decoder=2,
                     n_head_encoder=2, n_head_decoder=2,
                     vocoder_convnext_channels=32,
                     vocoder_convnext_layers=2,
                     vocoder_convnext_mlp=64,
                     vocoder_channels=16,
                     vocoder_resblock_kernel_sizes=(3,),
                     vocoder_resblock_dilations=((1, 3),),
                     vocoder_periods=(2, 3), vocoder_num_scales=2)
    if args.vocoder_family == "hifigan":
        extra["vocoder_type"] = "hifigan"
    if args.fp32:
        extra["amp"] = False

    # ---- 3: durations ----
    ar_eval = None
    if args.durations == "teacher":
        teacher_extra = (dict(d_model_encoder=64, d_model_decoder=64,
                              n_layer_encoder=2, n_layer_decoder=2,
                              n_head_encoder=2, n_head_decoder=2,
                              max_epoch=60) if args.tiny else {})
        if args.fp32:
            teacher_extra["amp"] = False
        ar_eval = teacher_durations(
            args.workdir, feat_dir, lines, teacher_extra,
            ar_epochs=args.ar_epochs, device=args.device)
        # the extraction against the corpus's true durations: the
        # bootstrap's own health
        derrs, dt_all, de_all = [], [], []
        for line in lines:
            stem = os.path.splitext(
                os.path.basename(line.split("|")[0]))[0]
            dt = durations[stem]
            de = np.load(os.path.join(feat_dir, f"{stem}_alignment.npy"))
            derrs.append(float(np.abs(dt - de).mean()))
            dt_all += dt.tolist()
            de_all += de.tolist()
        ar_eval["duration_err_frames"] = round(float(np.mean(derrs)), 3)
        ar_eval["duration_corr"] = round(
            float(np.corrcoef(dt_all, de_all)[0, 1]), 3)
    else:
        for line in lines:
            stem = os.path.splitext(
                os.path.basename(line.split("|")[0]))[0]
            np.save(os.path.join(feat_dir, f"{stem}_alignment.npy"),
                    durations[stem])

    # ---- 4: the acoustic model (untrained baseline, then the run) ----
    base_dir = os.path.join(args.workdir, "ckpt_baseline")
    hp0, _ = write_acoustic_hparams(
        args.workdir, feat_dir, base_dir, 1, extra)
    cli_train.main(["--hp_file", hp0, "--max_steps", "1"] + dev)

    save_dir = os.path.join(args.workdir, "ckpt")
    hp_path, cfg = write_acoustic_hparams(
        args.workdir, feat_dir, save_dir, args.max_epoch, extra)
    cli_train.main(["--hp_file", hp_path] + dev)
    first = max(1, args.max_epoch - 9)
    cli_avg.main(["--save_dir", save_dir, "--start_epoch", str(first),
                  "--end_epoch", str(args.max_epoch)])
    avg_name = f"average_epoch{first}-epoch{args.max_epoch}"

    # ---- 5: the vocoder on the same WAVs ----
    voc_save = os.path.join(args.workdir, "ckpt_voc")
    cli_voc.main(["--hp_file", hp_path,
                  "--wav_script", os.path.join(args.workdir,
                                               "wav_paths.txt"),
                  "--max_steps", str(args.voc_steps),
                  "--batch_size", "8",
                  "--save_every", str(args.voc_steps),
                  "--sample_rate", str(SR), "--n_fft", str(N_FFT),
                  "--set", f"save_dir={voc_save!r}"] + dev)
    voc_gen_dir = os.path.join(voc_save, "generator")

    # ---- 6: text -> waveform ----
    def synth(load, out):
        cli_synth.main(["--load_name", load, "--save", out,
                        "--batch_size", "8", "--max_frames", "96",
                        "--vocoder", voc_gen_dir,
                        "--sample_rate", str(SR),
                        "--hop_length", str(HOP)] + dev)

    base_gen = os.path.join(args.workdir, "gen_baseline")
    synth(os.path.join(base_dir, "epoch_1"), base_gen)
    gen_dir = os.path.join(args.workdir, "gen")
    synth(os.path.join(save_dir, avg_name), gen_dir)

    # ---- 7: scores: the mel domain (the acoustic model's learning), the
    # audio domain (the pipeline's), and the vocoder's copy-synthesis
    # floor, which no acoustic model can beat through that vocoder ----
    base_mel = mel_scores(base_gen, feat_dir)
    trained_mel = mel_scores(gen_dir, feat_dir)
    var_eval = None
    if not args.no_variance:
        # the pitch/energy predictors' curves (standardized units)
        recs = read_log(save_dir)
        var_eval = {}
        for key in ("loss_f0", "loss_energy"):
            var_eval[f"{key}_first"] = round(
                float(np.mean([r[key] for r in recs[:5]])), 4)
            var_eval[f"{key}_last"] = round(
                float(np.mean([r[key] for r in recs[-5:]])), 4)
    baseline = audio_scores(base_gen, feat_dir, args.workdir,
                            device=args.device)
    trained = audio_scores(gen_dir, feat_dir, args.workdir,
                           device=args.device)
    voc_quality = copy_synthesis_score(voc_gen_dir, cfg, feat_dir,
                                       args.workdir, device=args.device)
    copy_syn = voc_quality["copy_synthesis_mel_l1"]
    summary = {
        "baseline_mel_l1": round(base_mel["mel_l1"], 4),
        "trained_mel_l1": round(trained_mel["mel_l1"], 4),
        "mel_collapse_x": round(base_mel["mel_l1"]
                                / max(trained_mel["mel_l1"], 1e-9), 1),
        "baseline_audio_mel_l1": round(baseline["mel_l1"], 4),
        "baseline_audio_mcd": round(baseline["mcd"], 3),
        "trained_audio_mel_l1": round(trained["mel_l1"], 4),
        "trained_audio_mcd": round(trained["mcd"], 3),
        "copy_synthesis_mel_l1": round(copy_syn, 4),
        "audio_gap_to_vocoder_floor": round(
            trained["mel_l1"] - copy_syn, 4),
        "epochs": args.max_epoch, "voc_steps": args.voc_steps,
        "durations": args.durations,
        "vocoder_family": args.vocoder_family,
    }
    if ar_eval is not None:
        summary.update(ar_eval)
    if var_eval is not None:
        summary.update(var_eval)
    print(json.dumps(summary), flush=True)
    if var_eval is not None and not args.tiny:
        # the variance predictors learned. The bar is 1.5x, not -> 0: the
        # predictors see length-regulated phone features with no position
        # inside the phone, so the corpus's within-phone glides and
        # envelopes are a floor they cannot pass
        check(var_eval["loss_f0_last"] * 1.5 < var_eval["loss_f0_first"],
              "the pitch predictor did not learn", var_eval)
        check(var_eval["loss_energy_last"] * 1.5
              < var_eval["loss_energy_first"],
              "the energy predictor did not learn", var_eval)
    if ar_eval is not None and not args.tiny:
        # the AR teacher learned: its train loss fell 3x, the stop rule
        # ends within 10 % of the true length on average, and the
        # extraction attention is near-monotonic and covers the phones
        check(ar_eval["ar_train_loss_last"] * 3
              < ar_eval["ar_train_loss_first"],
              "the AR teacher's loss did not fall", ar_eval)
        check(ar_eval["ar_len_err_mean"] <= 0.10,
              "the AR teacher's stop rule missed the lengths", ar_eval)
        check(ar_eval["ar_monotonicity"] >= 0.90,
              "the AR teacher's attention is not monotonic", ar_eval)
        check(ar_eval["ar_coverage"] >= 0.80,
              "the AR teacher's attention does not cover the phones",
              ar_eval)
    if args.tiny:
        ok_acoustic = (trained_mel["mel_l1"] < 2.0
                       or trained_mel["mel_l1"] * 1.5
                       < base_mel["mel_l1"])
        ok_pipeline = trained["mel_l1"] < copy_syn + 1.5
    elif args.durations == "teacher":
        # rhythm-tolerant bars: the teacher's durations put the right
        # phones on a near-uniform rhythm, which padded mel-L1 punishes at
        # every deviation; DTW MCD scores the content
        ok_acoustic = trained_mel["mel_l1"] * 1.8 < base_mel["mel_l1"]
        ok_pipeline = trained["mcd"] < 75.0
    else:
        ok_acoustic = (trained_mel["mel_l1"] < 1.0
                       or trained_mel["mel_l1"] * 5
                       < base_mel["mel_l1"])
        ok_pipeline = trained["mel_l1"] < copy_syn + 1.0
    check(ok_acoustic, "acoustic model did not learn", summary)
    check(ok_pipeline, "pipeline did not reach its quality bar", summary)
    if not args.keep:
        shutil.rmtree(args.workdir)
    return summary


if __name__ == "__main__":
    main()
