"""Duration extraction from a trained AR teacher's cross-attention (the
port of transformer_tts_tpu/cli/extract_durations.py:41-276).

``python -m transformer_tts_tpu_torch.cli.extract_durations
      --load_name <AR checkpoint dir> [--script train.txt]
      [--align mas|argmax] [--out_dir DIR] [--stats_file F.json]
      [--device cuda]``

Runs the port's AR Transformer-TTS teacher-forced in eval mode with
``collect_attn=True`` on each utterance of the script and turns its
decoder-encoder attention (layers, heads, T/r, phones) into per-phone
durations:

* ``mas`` (default): monotonic alignment search, a Viterbi pass over
  each head's attention log-probabilities for the best monotonic path
  from (frame 0, phone 0) to (T-1, L-1), the phone advancing by 0 or 1
  per frame (Glow-TTS, Kim et al. 2020 §2.2); the head whose path has the
  highest mean log-probability wins. Every phone gets a frame when T/r >=
  L; below that, argmax.
* ``argmax``: the most focused head (F = mean_t max_l A[t, l]) and the
  count of attention-argmax hits per phone (Ren et al. 2019 §3.3).

Durations are scaled by the reduction rate and trimmed from the last
phone (or padded) so each utterance's sum is its mel frame count. Writes
``<mel_stem>_alignment.npy`` next to each mel (or under ``--out_dir``)
and prints the corpus means of ``attention_quality``'s focus,
monotonicity and coverage (and the MAS score).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def durations_from_attention(attn: np.ndarray, n_phones: int,
                             n_frames: int, r: int) -> np.ndarray:
    """(layers, H, T_q, L) cross-attention -> (n_phones,) int durations.

    Head choice: highest focus rate over the valid (T_q_valid, n_phones)
    block. Count argmax hits per phone over valid query positions; each
    query covers ``r`` output frames; fix the rounding remainder on the
    last attended phone so ``sum == n_frames``.
    """
    t_q_valid = max((n_frames + r - 1) // r, 1)
    a = attn[:, :, :t_q_valid, :n_phones]         # (layers, H, t_q, L)
    focus = a.max(axis=-1).mean(axis=-1)          # (layers, H)
    li, hi = np.unravel_index(np.argmax(focus), focus.shape)
    best = a[li, hi]                              # (t_q, L)
    hits = best.argmax(axis=-1)                   # (t_q,)
    durations = np.bincount(hits, minlength=n_phones).astype(np.int64) * r
    excess = int(durations.sum()) - n_frames
    # walk from the last phone, trimming (or padding) the tail
    i = n_phones - 1
    while excess > 0 and i >= 0:
        cut = min(excess, int(durations[i]))
        durations[i] -= cut
        excess -= cut
        i -= 1
    if excess < 0:
        durations[hits[-1] if len(hits) else n_phones - 1] += -excess
    return durations.astype(np.int32)


def _mas_counts(logp: np.ndarray) -> np.ndarray:
    """Viterbi monotonic path through (T, L) log-probs -> per-phone
    frame counts. Step rule: phone index advances 0 or 1 per frame;
    path runs (0,0) -> (T-1, L-1), so every phone gets >= 1 frame when
    T >= L (Glow-TTS MAS, Kim et al. 2020 §2.2)."""
    t_q, n = logp.shape
    q = np.full((t_q, n), -np.inf)
    q[0, 0] = logp[0, 0]
    for t in range(1, t_q):
        stay = q[t - 1]
        move = np.concatenate([[-np.inf], q[t - 1, :-1]])
        q[t] = logp[t] + np.maximum(stay, move)
    counts = np.zeros((n,), np.int64)
    l = n - 1
    for t in range(t_q - 1, -1, -1):
        counts[l] += 1
        if t > 0 and l > 0 and q[t - 1, l - 1] >= q[t - 1, l]:
            l -= 1
    return counts


def mas_durations(attn: np.ndarray, n_phones: int, n_frames: int,
                  r: int):
    """(layers, H, T_q, L) attention -> (durations, (layer, head), score).

    Runs MAS on every head over the valid block; selects the head whose
    best monotonic path has the highest per-frame log-probability.
    """
    t_q_valid = max((n_frames + r - 1) // r, 1)
    if t_q_valid < n_phones:
        # MAS needs >= 1 frame per phone; degenerate clip -> argmax
        d = durations_from_attention(attn, n_phones, n_frames, r)
        return d, (0, 0), float("-inf")
    a = attn[:, :, :t_q_valid, :n_phones].astype(np.float64)
    logp = np.log(np.maximum(a, 1e-8))
    best = None
    for li in range(a.shape[0]):
        for hi in range(a.shape[1]):
            counts = _mas_counts(logp[li, hi])
            score = float(
                logp[li, hi][np.arange(t_q_valid),
                             np.repeat(np.arange(n_phones), counts)]
                .mean())
            if best is None or score > best[2]:
                best = (counts, (li, hi), score)
    counts, head, score = best
    durations = counts * r
    excess = int(durations.sum()) - n_frames
    i = n_phones - 1
    while excess > 0 and i >= 0:
        cut = min(excess, int(durations[i]))
        durations[i] -= cut
        excess -= cut
        i -= 1
    if excess < 0:
        durations[n_phones - 1] += -excess
    return durations.astype(np.int32), head, score


def attention_quality(attn: np.ndarray, n_phones: int, n_frames: int,
                      r: int, head=None) -> dict:
    """Alignment-quality metrics of the selected (most focused) head.

    * ``focus``: F = mean_t max_l A[t, l] — Ren et al. 2019 §3.3's
      head-selection criterion; 1/n_phones for uniform attention, -> 1
      for a hard alignment.
    * ``monotonicity``: fraction of consecutive valid query steps whose
      argmax phone index does not decrease — 1.0 for a perfectly
      monotonic (diagonal-ish) alignment, ~0.5 for noise.
    * ``coverage``: fraction of phones receiving at least one frame —
      a degenerate all-frames-on-one-phone alignment scores
      1/n_phones.

    ``head``: evaluate this (layer, head) instead of the most-focused
    one (e.g. the MAS-selected head). All three metrics are computed
    from the head's RAW argmax hits — for a MAS-selected head they
    remain an independent diagnostic (MAS paths are monotonic by
    construction, raw argmax is not).
    """
    t_q_valid = max((n_frames + r - 1) // r, 1)
    a = attn[:, :, :t_q_valid, :n_phones]
    focus = a.max(axis=-1).mean(axis=-1)
    li, hi = head if head is not None else \
        np.unravel_index(np.argmax(focus), focus.shape)
    hits = a[li, hi].argmax(axis=-1)
    mono = float(np.mean(np.diff(hits) >= 0)) if len(hits) > 1 else 1.0
    return {"focus": float(focus[li, hi]), "monotonicity": mono,
            "coverage": float(len(np.unique(hits)) / n_phones)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_name", type=str, required=True,
                        help="trained AR Transformer-TTS checkpoint dir")
    parser.add_argument("--hp_file", type=str, default=None)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--script", type=str, default=None,
                        help="corpus script (default hp.train_script)")
    parser.add_argument("--out_dir", type=str, default=None,
                        help="write here instead of next to the mels")
    parser.add_argument("--stats_file", type=str, default=None,
                        help="write the corpus means of the alignment "
                             "quality (focus, monotonicity, coverage) "
                             "here as JSON")
    parser.add_argument("--align", choices=("mas", "argmax"),
                        default="mas",
                        help="mas: monotonic alignment search over the "
                             "best head (default); argmax: the focus-rate "
                             "recipe")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    import torch
    from transformer_tts_tpu_torch.config import is_nar_model, load_hparams
    from transformer_tts_tpu_torch.data.batching import collate
    from transformer_tts_tpu_torch.data.dataset import TTSDataset
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    from transformer_tts_tpu_torch.ops.masks import create_masks
    from transformer_tts_tpu_torch.train.checkpoint import (
        load_checkpoint, resolve_checkpoint)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch finds no CUDA device "
                           "(pass --device cpu to run on the CPU)")
    load_dir = args.load_name
    hp_dir = (os.path.dirname(os.path.normpath(load_dir))
              if os.path.basename(os.path.normpath(load_dir)).startswith(
                  ("epoch_", "average_")) else load_dir)
    hp = load_hparams(args.hp_file or os.path.join(hp_dir, "hparams.py"))
    if is_nar_model(hp.model):
        raise SystemExit("extract_durations needs an AR Transformer-TTS "
                         f"teacher; snapshot has model={hp.model!r}")
    if args.script:
        hp.train_script = args.script
    model = build_transformer_tts(hp, device=device)
    load_checkpoint(model, resolve_checkpoint(load_dir, args.epoch))
    model.eval()
    r = hp.reduction_rate

    def teacher_attn(batch):
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
             if k in ("text", "pos_text", "mel", "pos_mel", "spk_emb")}
        src_mask, trg_mask = create_masks(b["pos_text"],
                                          b["pos_mel"][:, :-r:r],
                                          model="transformer")
        with torch.no_grad():
            out = model(b["text"], b["mel"][:, :-r:r], src_mask, trg_mask,
                        spk_emb=b.get("spk_emb"), collect_attn=True)
        return out.attn_dec_enc[0].float().cpu().numpy()

    # no variance targets: the alignment siblings are what this makes
    dataset = TTSDataset(hp.train_script, hp, pitch_pred=False,
                         energy_pred=False)
    stats = []
    for idx in range(len(dataset)):
        sample = dataset[idx]
        batch = collate([sample], hp, pad_batch=False)
        attn = teacher_attn(batch)
        n_phones = int(batch["text_length"][0])
        # the FastSpeech 2 mel is the file: the AR sample's frames less
        # its go frame (the collated mel_length is rounded up to r)
        n_frames = sample["mel"].shape[0] - 1
        if args.align == "mas":
            durations, head, score = mas_durations(attn, n_phones,
                                                   n_frames, r)
            s = attention_quality(attn, n_phones, n_frames, r, head=head)
            s["mas_logp"] = score
        else:
            durations = durations_from_attention(attn, n_phones, n_frames,
                                                 r)
            s = attention_quality(attn, n_phones, n_frames, r)
        stats.append(s)
        src = sample["mel_name"]
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            dest = os.path.join(
                args.out_dir,
                os.path.basename(src).replace(".npy", "_alignment.npy"))
        else:
            dest = src.replace(".npy", "_alignment.npy")
        np.save(dest, durations)
        print(f"save {dest} (sum={int(durations.sum())}, "
              f"frames={n_frames})")
        sys.stdout.flush()

    keys = [k for k in ("focus", "monotonicity", "coverage", "mas_logp")
            if k in stats[0]]
    agg = {k: float(np.mean([s[k] for s in stats])) for k in keys}
    agg["n_utts"] = len(stats)
    agg["align"] = args.align
    print(f"alignment quality: {agg}")
    if args.stats_file:
        with open(args.stats_file, "w") as fh:
            json.dump(agg, fh)


if __name__ == "__main__":
    main()
