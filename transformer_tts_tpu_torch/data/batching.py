"""Collation of synthesis inputs (the port of the test-mode part of
``collate``, transformer_tts_tpu/data/batching.py:25-101).

Text is padded with 0 to the smallest of ``hp.text_buckets`` that holds
the longest utterance, as the JAX package pads it, so both packages see
the same padded length; ``pos_text`` is 1-based and 0 on padding.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def pick_bucket(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value; past the largest, round up to a multiple
    of 128."""
    for b in sorted(buckets):
        if value <= b:
            return b
    return -(-value // 128) * 128


def collate(samples: List[dict], hp) -> Dict[str, np.ndarray]:
    """-> {text (B, L), pos_text (B, L), text_length (B,)} int32 arrays."""
    b = len(samples)
    text_len = pick_bucket(max(s["text_length"] for s in samples),
                           hp.text_buckets)
    text = np.zeros((b, text_len), np.int32)
    pos_text = np.zeros((b, text_len), np.int32)
    for i, s in enumerate(samples):
        n = s["text_length"]
        text[i, :n] = s["text"]
        pos_text[i, :n] = np.arange(1, n + 1)
    return {"text": text, "pos_text": pos_text,
            "text_length": np.array([s["text_length"] for s in samples],
                                    np.int32)}
