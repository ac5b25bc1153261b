"""Objective evaluation: mel-L1 and mel-cepstral distortion (the port of
transformer_tts_tpu/eval.py:25-91, numpy on the host as there).

* ``mel_l1``: mean absolute error over the frames both mels have.
* ``mcd``: 10/ln(10) * sqrt(2 * sum_k (c1_k - c2_k)^2) averaged over
  frames, where c are mel-cepstra (the orthonormal DCT-II of the
  natural-log mel, k from 1 to n_mfc: c0, the energy term, is left out).
* ``dtw_path``: monotonic dynamic time warping on the cepstral distance,
  which ``mcd`` takes when the two lengths differ.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_LOG10 = 10.0 / np.log(10.0)


def mel_cepstra(log_mel: np.ndarray, n_mfc: int = 13) -> np.ndarray:
    """(T, n_mels) natural-log mel -> (T, n_mfc) cepstra (DCT-II, ortho),
    c0 excluded."""
    t, m = log_mel.shape
    n = np.arange(m)
    basis = np.cos(np.pi * (n[None, :] + 0.5) * np.arange(m)[:, None] / m)
    basis *= np.sqrt(2.0 / m)
    basis[0] *= np.sqrt(0.5)
    cep = log_mel @ basis.T                     # (T, m)
    return cep[:, 1:n_mfc + 1]


def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over a (T1, T2) local-cost matrix; returns index
    arrays (path1, path2)."""
    t1, t2 = cost.shape
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        c = cost[i - 1]
        for j in range(1, t2 + 1):
            acc[i, j] = c[j - 1] + min(acc[i - 1, j], acc[i, j - 1],
                                       acc[i - 1, j - 1])
    # backtrack
    i, j = t1, t2
    p1, p2 = [], []
    while i > 0 and j > 0:
        p1.append(i - 1)
        p2.append(j - 1)
        steps = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(steps, key=lambda s: s[0])
    # explicit dtype: an empty path would otherwise default to float64
    # and break fancy indexing downstream
    return (np.asarray(p1[::-1], dtype=np.int64),
            np.asarray(p2[::-1], dtype=np.int64))


def mcd(ref: np.ndarray, gen: np.ndarray, *, n_mfc: int = 13,
        use_dtw: Optional[bool] = None) -> float:
    """Mel-cepstral distortion in dB between two (T, n_mels) log-mels.

    ``use_dtw``: None = auto (DTW when lengths differ).
    """
    if ref.shape[0] == 0 or gen.shape[0] == 0:
        raise ValueError("mcd: empty mel (an untrained duration "
                         "predictor can synthesize 0 frames)")
    c1 = mel_cepstra(ref, n_mfc)
    c2 = mel_cepstra(gen, n_mfc)
    if use_dtw is None:
        use_dtw = c1.shape[0] != c2.shape[0]
    if use_dtw:
        d = np.sqrt(
            ((c1[:, None, :] - c2[None, :, :]) ** 2).sum(-1))
        p1, p2 = dtw_path(d)
        c1, c2 = c1[p1], c2[p2]
    else:
        n = min(c1.shape[0], c2.shape[0])
        c1, c2 = c1[:n], c2[:n]
    dist = np.sqrt(2.0 * ((c1 - c2) ** 2).sum(-1))
    return float(_LOG10 * dist.mean())


def mel_l1(ref: np.ndarray, gen: np.ndarray) -> float:
    n = min(ref.shape[0], gen.shape[0])
    return float(np.abs(ref[:n] - gen[:n]).mean())
