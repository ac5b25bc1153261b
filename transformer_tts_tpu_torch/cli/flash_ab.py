"""Attention kernels against their plain versions and the library's
attention (the port of scripts/flash_ab.py).

At the training shape of record, B 32, H 4, d 96 in bf16 with every key
valid, each mode times three paths on the same inputs:

* ``kernel``: the port's wrappers -- ``flash_attention`` (K1/K1-d, K2 in
  the backward) or, for ``relpos``, ``flash_relpos_attention`` (K4/K4-d,
  K5);
* ``plain``: their plain PyTorch versions, through autograd;
* ``sdpa``: ``F.scaled_dot_product_attention`` (for ``relpos`` with the
  relative term built in device memory as its additive mask), the
  library's one call.

Modes: ``fwd`` (forward, no dropout), ``bwd`` (forward and backward, no
dropout), ``drop`` (forward and backward, dropout 0.1) and ``relpos``
(forward and backward, dropout 0.1). Times are device times from CUDA
events on the card (the median of ``--reps`` calls after 3 warm-up calls,
each behind a spin kernel that holds the stream while the host enqueues
the call, so the host's launch time stays out), host times on the CPU;
each kernel line also gives its output's largest difference from the
plain version's (dropout masks differ from SDPA's, so SDPA is timed
only).

    python -m transformer_tts_tpu_torch.cli.flash_ab [fwd|bwd|drop|relpos]
        [T ...] [--batch 32] [--reps 10] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import statistics
import time
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from transformer_tts_tpu_torch.ops import flash_attention as fa
from transformer_tts_tpu_torch.ops import flash_relpos as fr

MODES = ("fwd", "bwd", "drop", "relpos")
HEADS, HEAD_DIM = 4, 96
DROPOUT = 0.1
SEED = 3
HOLD_CYCLES = 20_000_000        # ~10 ms at the H100's clock


def time_ms(fn: Callable[[], object], reps: int, device) -> float:
    """Median ms of ``fn`` over ``reps`` calls after 3 warm-up calls:
    CUDA-event device time on the card, host time on the CPU."""
    for _ in range(3):
        fn()
    times = []
    cuda = torch.device(device).type == "cuda"
    for _ in range(reps):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _inputs(b: int, t: int, device, relative: bool):
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(device, torch.bfloat16)
    xs = {"q": rnd(b, HEADS, t, HEAD_DIM), "k": rnd(b, HEADS, t, HEAD_DIM),
          "v": rnd(b, HEADS, t, HEAD_DIM)}
    if relative:
        xs["q_v"] = rnd(b, HEADS, t, HEAD_DIM)
        xs["p"] = rnd(HEADS, t, HEAD_DIM)
    k_len = torch.full((b,), t, dtype=torch.int32, device=device)
    return xs, k_len, rnd(b, HEADS, t, HEAD_DIM)


def _paths(xs, k_len, rate: float, relative: bool) -> Dict[str, Callable]:
    """{path: fn(q, k, v) -> o} for the mode."""
    scale = 1.0 / math.sqrt(HEAD_DIM)
    if relative:
        q_v, p = xs["q_v"], xs["p"]

        def bias():
            rel = fr.rel_shift(torch.matmul(q_v.float(),
                                            p.float().transpose(-1, -2)))
            return (rel * scale).to(q_v.dtype)
        return {
            "kernel": lambda q, k, v: fr.flash_relpos_attention(
                q, q_v, k, v, p, k_len, dropout_rate=rate,
                dropout_seed=SEED)[0],
            "plain": lambda q, k, v: fr.flash_relpos_attention_fwd_reference(
                q, q_v, k, v, p, k_len, scale, rate, SEED)[0],
            "sdpa": lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias(), dropout_p=rate),
        }
    return {
        "kernel": lambda q, k, v: fa.flash_attention(
            q, k, v, k_len, dropout_rate=rate, dropout_seed=SEED)[0],
        "plain": lambda q, k, v: fa.flash_attention_fwd_reference(
            q, k, v, k_len, scale, rate, SEED)[0],
        "sdpa": lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, dropout_p=rate),
    }


def run_mode(mode: str, t: int, *, batch: int = 32, reps: int = 10,
             device="cuda") -> List[dict]:
    """One mode at sequence length ``t``: a dict per path with its ms
    and, for the kernel, its output's largest difference from the plain
    version's."""
    relative = mode == "relpos"
    rate = DROPOUT if mode in ("drop", "relpos") else 0.0
    backward = mode != "fwd"
    xs, k_len, do = _inputs(batch, t, device, relative)
    out = []
    outputs = {}
    for name, fn in _paths(xs, k_len, rate, relative).items():
        leaves = [xs[n].detach().requires_grad_(backward)
                  for n in ("q", "k", "v")]

        def call():
            o = fn(*leaves)
            if backward:
                torch.autograd.grad(o, leaves, do)
            return o
        with torch.no_grad() if not backward else torch.enable_grad():
            outputs[name] = call().detach().float()
            ms = time_ms(call, reps, device)
        out.append(dict(mode=mode, T=t, path=name, ms=ms))
    err = float((outputs["kernel"] - outputs["plain"]).abs().max())
    out[0]["max_abs_err"] = err
    return out


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("args", nargs="*",
                    help=f"modes of {MODES} and sequence lengths")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    modes = [x for x in a.args if not x.isdigit()] or ["fwd", "bwd"]
    for mode in modes:
        if mode not in MODES:
            ap.error(f"mode {mode!r}: one of {MODES}")
    lengths = [int(x) for x in a.args if x.isdigit()] or [1024]
    results = []
    for t in lengths:
        for mode in modes:
            for r in run_mode(mode, t, batch=a.batch, reps=a.reps,
                              device=a.device):
                err = (f"  max|kernel - plain| {r['max_abs_err']:.3g}"
                       if "max_abs_err" in r else "")
                print(f"T={t} {mode:6s} {r['path']:6s} {r['ms']:9.4f} ms"
                      f"{err}", flush=True)
                results.append(r)
    return results


if __name__ == "__main__":
    main()
