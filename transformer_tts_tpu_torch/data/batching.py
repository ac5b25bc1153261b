"""Collation to bucket shapes (the port of ``pick_bucket``,
``pick_batch_bucket`` and ``collate``, transformer_tts_tpu/data/
batching.py:25-197, for FastSpeech 2 and the AR Transformer-TTS).

Text pads with 0 to the smallest of ``hp.text_buckets`` that holds the
longest utterance and, in training, mels pad to the smallest of
``hp.length_buckets``, as the JAX package pads them, so shapes repeat from
step to step and both packages see the same padded lengths. ``pos_text``
and ``pos_mel`` are 1-based and 0 on padding. Pad values: mel -0.5 when
normalised, else -5.0, and discrete codes (int mels) 320 in int32; f0,
energy and alignment 0; the stop token is 0 on
a row's mel frames and 1.0 past them. For the AR models the mel bucket is
a multiple of ``reduction_rate`` and ``pos_mel`` covers the length
rounded up to it. With ``pad_batch`` the batch grows to a power of two
with empty rows; durations that overflow the mel bucket are cut at its
edge. Conditioning (for synthesis samples too): ``spk_emb`` and the
mel-to-mel student's ``spk_emb_post``, each (B,) int32 ids or (B, dim)
float32 x-vectors, ``accent`` (B, text bucket) int32 padded with 0,
``gender`` and ``hop_size`` (B,) int32; pad rows hold 0. The
pregenerated teacher corpus's ``teacher_mel`` and ``teacher_phone`` pad
to the mel bucket like ``mel``, with the mel pad and 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

MEL_PAD_NORMALIZED = -0.5
MEL_PAD_RAW = -5.0
CODE_PAD = 320              # the discrete codes' pad (the loss ignores it)


def pick_bucket(value: int, buckets: Sequence[int], *,
                multiple: int = 1) -> int:
    """Smallest bucket >= value that is a multiple of ``multiple``; past
    the largest, round up to a multiple of max(128, multiple)."""
    for b in sorted(buckets):
        if value <= b and b % multiple == 0:
            return b
    step = max(128, multiple)
    return -(-value // step) * step


def pick_batch_bucket(n: int, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32,
                                                        64, 128),
                      multiple: int = 1) -> int:
    """Smallest bucket >= n that is a multiple of ``multiple``; past the
    largest, round up to a multiple of max(128, multiple)."""
    for b in buckets:
        if n <= b and b % multiple == 0:
            return b
    step = max(128, multiple)
    return -(-n // step) * step


def _clip_durations(alignment: np.ndarray, mel_len: int) -> None:
    """Cut each row's durations where their sum passes ``mel_len``."""
    for i in np.flatnonzero(alignment.sum(axis=1) > mel_len):
        d = alignment[i]                      # a view: edits stay
        cum = np.cumsum(d)
        d[cum > mel_len] = 0
        edge = np.searchsorted(cum, mel_len, side="left")
        if edge < len(d):
            d[edge] = mel_len - (cum[edge - 1] if edge > 0 else 0)


def _conditioning(samples: List[dict], b: int,
                  text_len: int) -> Dict[str, np.ndarray]:
    out = {}
    for key in ("spk_emb", "spk_emb_post"):
        if key not in samples[0]:
            continue
        v0 = samples[0][key]
        if np.ndim(v0) == 0:
            arr = np.zeros((b,), np.int32)
        else:
            arr = np.zeros((b, len(v0)), np.float32)
        for i, s in enumerate(samples):
            arr[i] = s[key]
        out[key] = arr
    if "accent" in samples[0]:
        arr = np.zeros((b, text_len), np.int32)
        for i, s in enumerate(samples):
            arr[i, :len(s["accent"])] = s["accent"]
        out["accent"] = arr
    for key in ("gender", "hop_size"):
        if key in samples[0]:
            out[key] = np.array([s[key] for s in samples]
                                + [0] * (b - len(samples)), np.int32)
    return out


def collate(samples: List[dict], hp, *, text_len: Optional[int] = None,
            mel_len: Optional[int] = None, batch: Optional[int] = None,
            pad_batch: bool = False,
            batch_multiple: int = 1) -> Dict[str, np.ndarray]:
    """-> {text, pos_text, text_length} int32 arrays and the samples'
    conditioning, and for training samples also mel (B, T, mel_dim),
    pos_mel, mel_length, stop_token and (FastSpeech 2) alignment, f0 and
    energy. ``text_len``, ``mel_len`` and ``batch`` fix the padded shape
    (the loader's ``fixed_shapes``); else the buckets pick it, the batch a
    multiple of ``batch_multiple`` with ``pad_batch``."""
    from transformer_tts_tpu_torch.config import is_nar_model
    r = 1 if is_nar_model(hp.model) else hp.reduction_rate
    n_real = len(samples)
    if batch is not None:
        b = batch
    elif pad_batch:
        b = pick_batch_bucket(n_real, multiple=batch_multiple)
    else:
        b = n_real
    text_len = text_len or pick_bucket(
        max(s["text_length"] for s in samples), hp.text_buckets)
    text = np.zeros((b, text_len), np.int32)
    pos_text = np.zeros((b, text_len), np.int32)
    for i, s in enumerate(samples):
        n = s["text_length"]
        text[i, :n] = s["text"]
        pos_text[i, :n] = np.arange(1, n + 1)
    out = {"text": text, "pos_text": pos_text,
           "text_length": np.array([s["text_length"] for s in samples]
                                   + [0] * (b - n_real), np.int32)}
    out.update(_conditioning(samples, b, text_len))
    if "mel" not in samples[0]:
        return out

    mel_len = mel_len or pick_bucket(
        max(s["mel_length"] for s in samples), hp.length_buckets,
        multiple=r)
    mel_len = -(-mel_len // r) * r
    if np.issubdtype(samples[0]["mel"].dtype, np.integer):
        mel_pad, mel_dtype = CODE_PAD, np.int32
    else:
        mel_dtype = np.float32
        mel_pad = (MEL_PAD_NORMALIZED if hp.mean_file is not None
                   else MEL_PAD_RAW)
    mel = np.full((b, mel_len, samples[0]["mel"].shape[1]), mel_pad,
                  mel_dtype)
    pos_mel = np.zeros((b, mel_len), np.int32)
    stop = np.ones((b, mel_len), np.float32)
    for i, s in enumerate(samples):
        m = s["mel"][:mel_len]
        mel[i, :len(m)] = m
        stop[i, :len(m)] = 0.0
        n = min(s["mel_length"], mel_len)
        pos_mel[i, :n] = np.arange(1, n + 1)
    out.update(mel=mel, pos_mel=pos_mel, stop_token=stop, mel_length=np.array(
        [s["mel_length"] for s in samples] + [0] * (b - n_real), np.int32))
    for key, pad in (("teacher_mel", mel_pad), ("teacher_phone", 0.0)):
        if key in samples[0]:
            arr = np.full((b, mel_len, samples[0][key].shape[1]), pad,
                          np.float32)
            for i, s in enumerate(samples):
                v = s[key][:mel_len]
                arr[i, :len(v)] = v
            out[key] = arr
    for key, dtype in (("alignment", np.int32), ("f0", np.float32),
                       ("energy", np.float32)):
        if key in samples[0]:
            length = text_len if key == "alignment" else mel_len
            arr = np.zeros((b, length), dtype)
            for i, s in enumerate(samples):
                v = np.asarray(s[key], dtype)[:length]
                arr[i, :len(v)] = v
            out[key] = arr
    if "alignment" in out:
        _clip_durations(out["alignment"], mel_len)
    return out
