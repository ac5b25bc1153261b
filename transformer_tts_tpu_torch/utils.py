"""Training observability of the port (the port of ``StepTimer``,
``MetricsLogger``, ``start_profiler`` and ``stop_profiler``,
transformer_tts_tpu/utils.py:96-176).

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

import torch


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
