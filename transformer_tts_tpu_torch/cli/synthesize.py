"""Synthesis CLI of the PyTorch port (the port of
transformer_tts_tpu/cli/synthesize.py).

``python -m transformer_tts_tpu_torch.cli.synthesize --load_name DIR
      [--hp_file h.py] [--epoch N] [--test_script s.txt] [--save out_dir]
      [--max_frames 2048] [--batch_size N] [--use_prenet]
      [--pitch_perturbation] [--duration_perturbation] [--ref_mel r.npy]
      [--post_model STUDENT_DIR] [--save_prenet]
      [--wav] [--vocoder GEN_DIR] [--device cuda]``

``DIR`` and the hparams resolve as in the JAX CLI (:97-103, :122): an
``epoch_N`` or ``average_N`` directory is the checkpoint itself and takes
its hparams from its parent (the training CLI's ``save_dir``); any other
``DIR`` takes them from itself and, when it holds ``epoch_N``
subdirectories, loads ``--epoch N`` or else the newest; a directory
without them (``hparams.py`` beside ``model.pt``) is the checkpoint.
``--hp_file`` replaces the resolved hparams file. The checkpoint is the
port's (``model.pt``, see train/checkpoint.py); ``hp.model`` picks
FastSpeech 2 or the AR Transformer-TTS (``--max_frames``,
``--use_prenet`` and the perturbations are FastSpeech 2's; the AR decode
runs up to 500 frame groups, through the KV-cached transformer decode or,
for ``decoder_type = "tacotron2"``, the Tacotron 2 loop
(``synthesize_tacotron2``); a GST model takes its style from
``--ref_mel``, a (T, mel) ``.npy`` normalized with the corpus statistics
and styling every utterance). For each utterance of the script it writes
``<idx>.npy`` (the de-normalized mel, float32, cut to its length) and,
for FastSpeech 2, ``<idx>_alignment.npy`` (predicted durations), and
prints the elapsed synthesis time. ``--wav`` also writes ``<idx>.wav``
(16-bit PCM at ``--sample_rate``) from the de-normalized log-mel by
Griffin-Lim (32 iterations; ``--n_fft``, ``--hop_length``); ``--vocoder``
(a ``generator`` export or a ``vocoder_<k>`` directory of
cli/train_vocoder.py) vocodes it instead and implies ``--wav``: each mel
goes through ``vocode_utterance`` (infer/synthesize.py), zero-padded to a
bucket of ``hp.length_buckets``, the generator in fp32, the waveform cut
to frames × hop samples. The waveforms are not part of the elapsed time,
as in the JAX CLI. A conditioned model reads each line's conditioning as
training does (data/dataset.py): the speaker id of column 2 or the
``_xvector.npy`` beside the line's mel name, the accents of column 2 and
the hop size of the mel name, so each line takes its own voice. It runs on the CUDA device unless ``--device cpu`` is
given, and raises when that device is missing. SQ-VAE
hparams (``model = "SQFastSpeech2"``) are refused, as the JAX CLI cannot
restore them either: such a model synthesizes through
``infer.synthesize.synthesize_fastspeech2``.

The mel-to-mel line (the JAX CLI's :111-119, :184-200, :277-300):
``--post_model STUDENT_DIR`` (a mel-mel training's ``save_dir``,
``epoch_N`` or checkpoint directory, resolved as ``--load_name``; its own
``hparams.py`` gives the student's version and options, else the
resolved hparams do) refines each FastSpeech 2 mel by the student in the
same call (``synthesize_fastspeech2_post``): added to dims
``:mel_dim_post`` at versions 3, 5 and 6, in their place at the others;
the whole checkpoint loads, the VQ codebook included, where the JAX CLI
restores the student's parameters only. With a perturbation the port
refines the perturbed forward; the JAX CLI refines a second, unperturbed
forward, cut to the perturbed lengths. A text-mel-mel checkpoint
synthesizes through ``synthesize_integrate``: ``<idx>.npy`` is the
refined mel, or with ``--save_prenet`` the mel_pre, and ``<idx>_prenet
.npy`` the mel_pre always, as in the reference.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_name", type=str, required=True,
                        help="checkpoint dir (save_dir, epoch_N, or a "
                             "directory with hparams.py and model.pt)")
    parser.add_argument("--hp_file", type=str, default=None)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--test_script", type=str, default=None)
    parser.add_argument("--save", type=str, default="./generated")
    parser.add_argument("--max_frames", type=int, default=2048)
    parser.add_argument("--batch_size", type=int, default=1)
    parser.add_argument("--use_prenet", action="store_true",
                        help="save the pre-postnet mel")
    parser.add_argument("--pitch_perturbation", action="store_true")
    parser.add_argument("--duration_perturbation", action="store_true")
    parser.add_argument("--ref_mel", type=str, default=None,
                        help="reference mel .npy (T, mel) of a GST model's "
                             "style")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--post_model", type=str, default=None,
                        help="mel-mel student checkpoint dir")
    parser.add_argument("--save_prenet", action="store_true",
                        help="text-mel-mel: save the mel_pre as the main "
                             "mel")
    parser.add_argument("--vocoder", type=str, default=None,
                        help="generator export or vocoder_<k> dir of "
                             "cli.train_vocoder; implies --wav")
    parser.add_argument("--wav", action="store_true",
                        help="also write waveforms (Griffin-Lim unless "
                             "--vocoder)")
    parser.add_argument("--sample_rate", type=int, default=22050)
    parser.add_argument("--hop_length", type=int, default=256)
    parser.add_argument("--n_fft", type=int, default=1024,
                        help="FFT size of the Griffin-Lim fallback")
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.config import (
        is_nar_model, is_sq_model, load_hparams)
    from transformer_tts_tpu_torch.data.batching import collate
    from transformer_tts_tpu_torch.data.dataset import ScriptDataset
    from transformer_tts_tpu_torch.data.readers import Normalizer
    from transformer_tts_tpu_torch.infer.synthesize import (
        sample_perturbation, synthesize_fastspeech2,
        load_post_model, synthesize_fastspeech2_post,
        synthesize_integrate, synthesize_tacotron2,
        synthesize_transformer_tts)
    from transformer_tts_tpu_torch.models import build_model
    from transformer_tts_tpu_torch.train.checkpoint import (
        load_checkpoint, resolve_checkpoint)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to synthesize on the CPU)")
    load_dir = args.load_name
    if os.path.basename(os.path.normpath(load_dir)).startswith(
            ("epoch_", "average_")):
        hp_dir = os.path.dirname(os.path.normpath(load_dir))
    else:
        hp_dir = load_dir
    hp = load_hparams(args.hp_file or os.path.join(hp_dir, "hparams.py"))
    if args.test_script:
        hp.test_script = args.test_script
    is_ar = not is_nar_model(hp.model)
    if is_sq_model(hp.model):
        raise ValueError(
            f"model={hp.model!r}: the synthesis CLI builds the plain "
            "FastSpeech 2 or the AR model, as the JAX CLI does, and cannot "
            "restore an SQ-VAE FastSpeech 2 checkpoint; synthesize it with "
            "infer.synthesize.synthesize_fastspeech2 on "
            "models.fastspeech2_sq.build_sq_fastspeech2's model")
    is_integrate = hp.architecture == "text-mel-mel"
    if args.post_model is not None and (is_ar or is_integrate):
        raise ValueError("--post_model refines a FastSpeech 2 mel; the AR "
                         "models and text-mel-mel checkpoints take none")
    os.makedirs(args.save, exist_ok=True)

    model = build_model(hp, device=device)
    load_checkpoint(model, resolve_checkpoint(load_dir, args.epoch))
    post = None
    if args.post_model is not None:
        post = load_post_model(args.post_model, hp, device)
    vocoder = None
    if args.vocoder is not None:
        from transformer_tts_tpu_torch.vocoder.trainer import (
            build_vocoder, restore_generator_params)
        args.wav = True
        vocoder = build_vocoder(hp, amp=False, device=device)
        vocoder.load_state_dict(restore_generator_params(args.vocoder,
                                                         device))
        vocoder.eval()
    normalizer = Normalizer(hp.mean_file, hp.var_file, hp.mel_dim)
    ref_mel = None
    if args.ref_mel is not None:
        ref = normalizer(np.load(args.ref_mel).astype(np.float32))
        ref_mel = torch.as_tensor(ref, dtype=torch.float32,
                                  device=device)[None]
    mean, var = normalizer.arrays()
    if mean is not None:
        mean = torch.as_tensor(mean, dtype=torch.float32, device=device)
        var = torch.as_tensor(var, dtype=torch.float32, device=device)

    dataset = ScriptDataset(hp.test_script, hp)
    prng = random.Random(77)
    start_time = time.time()
    elapsed = 0.0
    bs = max(1, args.batch_size)
    for lo in range(0, len(dataset), bs):
        chunk = list(range(lo, min(lo + bs, len(dataset))))
        batch = collate([dataset[i] for i in chunk], hp)
        text = torch.as_tensor(batch["text"], device=device)
        pos_text = torch.as_tensor(batch["pos_text"], device=device)
        cond = {k: torch.as_tensor(batch[k], device=device)
                for k in ("spk_emb", "accent", "hop_size") if k in batch}
        p_scale = sample_perturbation(prng) \
            if args.pitch_perturbation else 1.0
        d_scale = sample_perturbation(prng) \
            if args.duration_perturbation else 1.0
        t0 = time.time()
        if is_ar:
            # decoder_type picks the AR loop (the JAX CLI's :174-180)
            synth_ar = (synthesize_tacotron2
                        if hp.decoder_type.lower() == "tacotron2"
                        else synthesize_transformer_tts)
            mel, mel_len = synth_ar(
                model, text, pos_text, mean, var,
                spk_emb=cond.get("spk_emb"), ref_mel=ref_mel)
            durations = None
        elif is_integrate:
            refined, prenet, mel_len, durations = synthesize_integrate(
                model, text, pos_text, args.max_frames, mean, var,
                spk_emb_post=(torch.as_tensor(batch["spk_emb_post"],
                                              device=device)
                              if "spk_emb_post" in batch else None),
                **cond)
            mel = prenet if args.save_prenet else refined
            durations = durations.cpu().numpy()
            prenet_np = prenet.float().cpu().numpy()
            for j, idx in enumerate(chunk):
                np.save(os.path.join(args.save, f"{idx}_prenet.npy"),
                        prenet_np[j, :int(mel_len[j])])
        elif post is not None:
            post_model, p_hp = post
            mel, mel_len, durations = synthesize_fastspeech2_post(
                model, post_model, text, pos_text, args.max_frames, mean,
                var, version=p_hp.version, mel_dim_post=p_hp.mel_dim_post,
                pitch_scale=p_scale, duration_scale=d_scale,
                spk_emb=cond.get("spk_emb"), hop_size=cond.get("hop_size"))
            durations = durations.cpu().numpy()
        else:
            mel, mel_len, durations = synthesize_fastspeech2(
                model, text, pos_text, args.max_frames, mean, var,
                pitch_scale=p_scale, duration_scale=d_scale,
                use_prenet=args.use_prenet, **cond)
            durations = durations.cpu().numpy()
        # the copies to the host wait for the device
        mel_np = mel.float().cpu().numpy()
        lens = mel_len.cpu().tolist()
        elapsed += time.time() - t0

        for j, idx in enumerate(chunk):
            out_name = os.path.join(args.save, f"{idx}.npy")
            np.save(out_name, mel_np[j, :lens[j]])
            if durations is not None:
                np.save(os.path.join(args.save, f"{idx}_alignment.npy"),
                        durations[j])
            if args.wav and lens[j] > 0:
                _write_wav(os.path.join(args.save, f"{idx}.wav"),
                           mel_np[j, :lens[j]], hp, args, vocoder, device)
            print(f"save {out_name} ({lens[j]} frames)")
        sys.stdout.flush()

    print(f"elapsed time = {elapsed}")
    print(f"total time = {time.time() - start_time}")


def _write_wav(path, mel, hp, args, vocoder, device):
    """Vocode one de-normalized (T, mel_dim) log-mel, by the generator
    when given (``vocode_utterance``) or else by Griffin-Lim, and write it
    as a 16-bit WAV."""
    import torch
    from transformer_tts_tpu_torch.infer.synthesize import vocode_utterance
    from transformer_tts_tpu_torch.ops.features import write_wav
    from transformer_tts_tpu_torch.ops.melspectrogram import (
        griffin_lim_from_log_mel)
    mel = torch.as_tensor(mel, dtype=torch.float32, device=device)
    if vocoder is not None:
        audio = vocode_utterance(vocoder, mel, hp.length_buckets)
    else:
        with torch.no_grad():
            audio = griffin_lim_from_log_mel(
                mel, sample_rate=args.sample_rate, n_fft=args.n_fft,
                hop_length=args.hop_length, n_mels=hp.mel_dim)
    write_wav(path, audio.cpu().numpy(), args.sample_rate)


if __name__ == "__main__":
    main()
