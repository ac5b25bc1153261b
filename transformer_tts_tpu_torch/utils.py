"""Training observability and auxiliary tools of the port (the port of
transformer_tts_tpu/utils.py: ``freq_mask``, ``time_mask``,
``spec_augment`` and ``plot_mel_and_alignment`` :21-95, ``StepTimer``,
``MetricsLogger``, ``start_profiler`` and ``stop_profiler`` :96-176).

SpecAugment masks run in numpy on the host, drawing from the
``np.random.RandomState`` they are given (numpy's global one without),
as the JAX package's do; ``plot_mel_and_alignment`` saves a mel with its
duration boundaries through matplotlib's Agg backend.

``MetricsLogger`` writes one JSON line per logged step and the same
scalars (and, on request, grayscale images) as TensorBoard events through
the port's own ``train/tb_writer.py``. The profiler is ``torch.profiler``
with CPU activity, and CUDA activity when a CUDA device is present; on
``stop_profiler`` it writes a Chrome trace (``trace_<pid>.json``, viewed
with Perfetto or chrome://tracing) into the directory given to
``start_profiler``, where the JAX package writes an XProf trace.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch


# -- SpecAugment (numpy, on the host) ------------------------------------

def freq_mask(spec: np.ndarray, F: int = 10, num_masks: int = 1,
              replace_with_zero: bool = False,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    cloned = spec.copy()
    num_channels = cloned.shape[1]
    for _ in range(num_masks):
        f = rng.randint(0, F)
        if f == 0 or num_channels - f <= 0:
            continue
        f_zero = rng.randint(0, num_channels - f)
        fill = 0.0 if replace_with_zero else cloned.mean()
        cloned[:, f_zero:f_zero + f] = fill
    return cloned


def time_mask(spec: np.ndarray, T: int = 50, num_masks: int = 1,
              replace_with_zero: bool = False,
              rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    cloned = spec.copy()
    length = cloned.shape[0]
    for _ in range(num_masks):
        t = rng.randint(0, min(T, max(length - 1, 1)))
        if t == 0 or length - t <= 0:
            continue
        t_zero = rng.randint(0, length - t)
        fill = 0.0 if replace_with_zero else cloned.mean()
        cloned[t_zero:t_zero + t, :] = fill
    return cloned


def spec_augment(spec: np.ndarray, T: int = 50, F: int = 20,
                 num_T: int = 1, num_F: int = 1,
                 rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """(B, T, F) batch SpecAugment with zero fill: per row a time mask,
    then a frequency mask."""
    out = spec.copy()
    for i in range(out.shape[0]):
        out[i] = time_mask(out[i], T=T, num_masks=num_T,
                           replace_with_zero=True, rng=rng)
        out[i] = freq_mask(out[i], F=F, num_masks=num_F,
                           replace_with_zero=True, rng=rng)
    return out


# -- Alignment plot ---------------------------------------------------------

def plot_mel_and_alignment(mel: np.ndarray, durations: np.ndarray,
                           path: str, *, text_labels=None) -> str:
    """Save a mel image with vertical duration boundaries."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto",
              interpolation="none")
    boundaries = np.cumsum(np.asarray(durations))
    for x in boundaries[:-1]:
        ax.axvline(x=x - 0.5, color="white", linewidth=0.5)
    if text_labels is not None:
        starts = np.concatenate([[0], boundaries[:-1]])
        for s, e, lab in zip(starts, boundaries, text_labels):
            ax.text((s + e) / 2, mel.shape[1] - 4, str(lab),
                    ha="center", color="white", fontsize=6)
    ax.set_xlabel("frames")
    ax.set_ylabel("mel bin")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


class StepTimer:
    """Rolling per-step wall-clock with steps/sec."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self.last = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        dt = None
        if self.last is not None:
            dt = now - self.last
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        self.last = now
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)


class MetricsLogger:
    """JSONL metrics writer + TensorBoard event file: ``<log_dir>/
    train.jsonl`` (one line per ``log`` call) and
    ``events.out.tfevents.*`` for ``tensorboard --logdir <log_dir>``."""

    def __init__(self, log_dir: str):
        from transformer_tts_tpu_torch.train.tb_writer import TBEventWriter
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "train.jsonl")
        self._fh = open(self.path, "a")
        self._tb = TBEventWriter(log_dir)

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        self._tb.add_scalars(step, {k: v for k, v in rec.items()
                                    if k not in ("step", "time")})

    def log_image(self, step: int, tag: str, img) -> None:
        """A 2-D array (an attention map, a mel) as a TensorBoard image."""
        self._tb.add_image(step, tag, img)

    def close(self):
        self._fh.close()
        self._tb.close()


def start_profiler(log_dir: str) -> torch.profiler.profile:
    """Start and return a ``torch.profiler`` trace of CPU and (with a
    card) CUDA activity; ``stop_profiler`` writes it to ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``log_dir``; returns
    the trace's path."""
    prof.stop()
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path
