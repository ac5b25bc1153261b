#!/usr/bin/env python3
"""Drive the PyTorch port's FastSpeech 2 (transformer and conformer) and AR
Transformer-TTS synthesis and training on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; exits
non-zero, printing no result, without them. Phases, each fatal on failure
and each printing its wall time:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the paths (the Hopper design of the models'
   attention: K1/K1-d, K3-f/K3-d and K6/K6-d csrc/flash_fwd_sm90.cu and
   the fused K2, K3 and K6 backward csrc/flash_bwd_sm90.cu; the simple K1
   and K1-d with
   K3's and K6's forward, K2 with K3's and K6's backward; the Hopper
   design of the conformer's relative attention, K4/K4-d
   csrc/flash_relpos_fwd_sm90.cu and the fused K5
   csrc/flash_relpos_bwd_sm90.cu; the simple K4 and K4-d, K5), in
   parallel, from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, TF32 off:
   K1 (csrc/flash_attention_fwd.cu) and K4 (csrc/flash_relpos_fwd.cu):
   fp32 at 1e-4 on O and lse, bf16 against the plain version in fp32 on
   the same bf16 inputs at 2e-2 on O and 1e-3 on lse, rows with no valid
   key exactly 0, O bit for bit the same on a second launch; kernel,
   plain and library times at the synthesis shapes. K1-90, the Hopper
   design (csrc/flash_fwd_sm90.cu), likewise in bf16 (and at d = 64).
   K1-d (dropout 0.1) and K2 (csrc/flash_attention_bwd.cu, at dropout 0
   and 0.1 on the same seed) at k_len in {0, 1, 65, T}, T = 1000,
   T_q = 300 != T_k = 700, and the train step's (16, 4, 1024, 96) with
   k_len in {0, 1, 65, T}, with T_q = 768, and with its batch's mel
   lengths as k_len: O, dq, dk, dv at 1e-4 (fp32) and 2e-2 (bf16) times
   that tensor's own max|ref|, lse as K1; dk and dv exactly 0 for keys
   at or past k_len; in bf16 on both designs, the Hopper one (K1-d-90
   and the fused K2-90, csrc/flash_bwd_sm90.cu), whose launches must go
   to its kernels, and the simple one; every launch on its id's counter
   and O bit for bit on a second launch. K3, the causal mode of the same
   kernels, likewise (the Hopper design's K3-f-90, K3-d-90 and the fused
   K3-90, and the simple one) at the AR train step's (16, 4, 511, 96)
   with k_len T, 0, 1, 65 and the AR batch's decoder groups, at T_q !=
   T_k both ways and at d = 64. K4/K4-d (csrc/flash_relpos_fwd.cu, with
   dropout) and K5 (csrc/flash_relpos_bwd.cu, dq and dk/dv/dP), and in
   bf16 their Hopper design K4-90/K4-d-90 and the fused K5-90
   (csrc/flash_relpos_fwd_sm90.cu, csrc/flash_relpos_bwd_sm90.cu), at
   dropout 0 and 0.1 on the same seed, at k_len in {0, 1, 65, T}, T in
   {1024, 1000, 511}, d in {64, 96} (bf16, both designs; fp32 at T =
   1000, d = 96), and the conformer train step's (16, 4, 1024, 96) with
   its batch's mel lengths: O, dq_u, dq_v, dk, dv and dP at 1e-4 (fp32)
   and 2e-2 (bf16) of each tensor's own max|ref|, dk and dv exactly 0
   past k_len, O bit for bit the same on a second call, each launch on
   its id's counter. K4-90 also as K4 at the synthesis shapes. K6/K6-d
   and K6's backward likewise, in bf16 on both designs (the Hopper one's
   K6-90/K6-d-90 and fused K6-bwd-90, the bias mode of
   csrc/flash_fwd_sm90.cu and csrc/flash_bwd_sm90.cu; the simple one's
   bias argument of csrc/flash_attention_fwd.cu and
   csrc/flash_attention_bwd.cu, dq with dbias and dk/dv) at k_len in {0,
   1, 65, T}, T in {1000, 1024}, d in {64, 96}, fp32 at T = 1000, d = 96;
   and T_q = 300 != T_k = 700, where the rule sends bf16 to the simple
   kernels (T_k is not a multiple of 8): O, dq, dk, dv and dbias, dbias,
   dk and dv exactly 0 past k_len, O, dk, dv and dbias bit for bit on a
   second launch, each launch on its id's counter;
4. for each FastSpeech 2 flagship, the transformer one and the conformer
   one of egs/fastspeech2_conformer_ljspeech.py (d 384, 6+6 layers, 4
   heads of 96, random weights from seed 0):
   (a) teacher-forced forward (B=2, L=128, T=768), card fp32 (kernel
       path) against the CPU fp32 at 1e-3 max abs on mel_post, and card
       bf16 amp against the CPU fp32 at 5e-2 * max(1, max|ref|) (bf16
       keeps ~3 significant digits through 12 layers and the postnet);
   (b) synthesize_fastspeech2 with predicted durations at B=1 / 768 frames
       and B=8 / 2048 frames: a main path, whose kernel launches are
       counted with every count set to 0 just before it (6 launches of
       the path's kernel per call, one per decoder layer -- K1-90 for the
       transformer, K4-90 for the conformer -- and none of the others), with
       ms and RTF;
   (c) the synthesis CLI as a subprocess on a 3-line script;
5. training, the transformer FastSpeech 2 flagship at full width (bf16
   amp, dropout 0.1, Noam warmup 4000, clip 1.0):
   (a) one step on the card against one on the CPU from the same weights,
       fp32 with every dropout 0 (B=2, L=128, mel bucket 768, so the
       decoder takes K1 and K2) and warmup_step 10, so that Adam's first
       update is ~lr * sign(g): the loss; each gradient at 2e-2 of its own
       max|g|, 5e-3 for the decoder attention weights (key and
       pre-BatchNorm conv biases, zero but for rounding, below 1e-5 of the
       largest); each update against the CPU's where the two gradients
       bound their difference below 1e-3 lr; BatchNorm statistics; then
       bf16 amp on the card against the CPU's loss, grad_norm and the
       decoder attention weights' gradient norms;
   (b) the train step, the main path of training, on a fixed batch (B=16,
       text bucket 128, mel bucket 1024, 600-1000 frames per row): 3
       warm-up steps, then 10 timed with CUDA events, every launch count
       set to 0 just before (6 K1-d-90 and 6 K2-90 per step, no other
       kernel); ms/step, mel frames/s, peak memory; the loss
       finite; 3 steps under torch.profiler, printing the top 10 device
       operations (run in phase 9); then 20 steps with warmup_step 100
       whose loss must fall;
   (c) cli/train.py for 3 steps on a synthetic corpus (32 utterances of
       300-900 frames) and cli/synthesize.py on the checkpoint it saved;
   (d)-(f) the conformer flagship's training likewise: the card-vs-CPU
       step (decoder on K4 and K5 in fp32, on K4-90 and K5-90 alone in
       bf16; its decoder self-attention weights,
       linear_pos and the position biases at the attention tolerance,
       each with a non-zero card gradient), the timed step (6 K4-d-90 and
       6 K5-90 per step, no other kernel) and its profile, the
       two CLIs;
6. the AR Transformer-TTS flagship of egs/transformer_tts_ljspeech.py
   (the same widths, r 2, prenet dropout 0.5), each path counted from 0:
   (a) the teacher-forced eval forward over 300 decoder groups, 6 K3-f
       launches in fp32 and 6 K3-f-90 in bf16 amp and nothing else, card
       fp32 against the CPU at 1e-3 and bf16 amp at 5e-2 of max(1,
       max|ref|);
   (b) the KV-cached decode loop for 300 steps, no kernel launched, each
       step's group against the teacher-forced forward of the frames it
       fed itself (on K3-f) at 1e-3 of max(1, max|ref|);
   (c) synthesize_transformer_tts at B=1 and B=8, 500 decode steps, the
       decode replayed from its CUDA graph, no kernel launched: the
       graph's mel and lengths bit for bit the eager loop's, with no row
       stopping and with a stop bias at which rows stop at different
       steps; ms per call and per step and RTF of both; one graphed call
       under the profiler (run in phase 9);
   (d)-(f) training as in 5: the card-vs-CPU step (383 decoder groups on
       the simple K3-f and K3's backward in fp32, on K3-f-90 and K3-90
       alone in bf16), the timed step (6 K3-d-90 and 6 K3-90 per step, no
       other kernel), the two CLIs;
7. each kernel at its main path's own captured input (K1-90, K4-90: the
   first decoder layer of the B=8 synthesis call; K1-d-90 and K2-90,
   K3-d-90 and K3-90: the first decoder layer of the FastSpeech 2 and the
   AR train step, held there against their plain versions as in 3;
   K4-d-90 and K5-90: the first decoder layer of the conformer train
   step, likewise, the library
   yardstick SDPA with the relative bias (for K5 its backward with the
   bias's gradient, the rel_shift adjoint and two products);
   K3-f-90: the first decoder layer of 6(a)'s bf16 forward): kernel, plain
   and library ms, bound (for K3 over the causal pairs the inputs
   attend), error. The simple design's K1, K1-d, K2 dq and K2 dk/dv, K3-f,
   K3-d, K3 dq and K3 dk/dv, K4, K4-d, K5 dq and K5 dk/dv/dP on the same
   inputs, the same-run A/B ("A/B at ..." lines). K6-90, K6-d-90 and the
   fused K6-bwd-90 at the conformer step's input with the bias
   rel_shift(q_v P^T) built in device memory, and the simple K6, K6-d,
   K6-dq and K6-dkdv on the same input (the A/B): the path that launches
   them is the route A/B of the conformer's attention core (route 1
   K4-d-90 and K5-90, route 2 the bias then K6-d-90 and K6-bwd-90),
   counted from 0, O and the five gradients of the two routes within 2e-2
   of each one's max|ref|, and the routes' forward and forward+backward
   times;
8. attention-path timing, kernel against masked-fill, at T in
   {128, 256, 768, 2048} for the transformer's attention, {128, 256,
   512, 1024, 2048} for the conformer's (K4-90), and for the AR
   decoder's causal self-attention at T in {128, 256, 511, 1024, 2048},
   forward and forward with backward;
9. the profiles of 5(b), 5(e), 6(c) (B=1 and B=8: device operations per
   decode step, the copies among them, the bf16 weight copies the graph
   reads) and 6(e), each on a state or model built anew, after every
   timed phase: a profiler pass slows the host work of the rest of its
   process.

It then prints the phases' wall times, the kernels line (JSON), the
nvidia-smi line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # outside the tensor cores
PEAK_BYTES = 3.35e12          # HBM3
HOP_SECONDS = 256 / 22050     # one mel frame of audio
DEVICE = "cuda"
FLAGSHIP = {}                 # HParams overrides; empty = the defaults
# the two flagships: HParams overrides of the stacks, and the kernel that
# carries each one's decoder attention
PATHS = {
    "transformer": ({}, "K1-90"),
    "conformer": ({"encoder_type": "conformer",
                   "decoder_type": "conformer"}, "K4-90"),
}
TOLS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(ok: bool, msg: str):
    if not ok:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# a spin of ~2.5 ms at the H100's clock: the host enqueues the timed work
# meanwhile, so the events around it time the device alone
HOLD_CYCLES = 5_000_000


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up.
    Before each, a spin kernel (``torch.cuda._sleep``) holds the stream
    while the host enqueues ``fn``'s launches: the events time the
    device's work, not the host's launch latency, which a kernel of
    ~0.1 ms would not hide."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def simple_flash_attention(q, k, v, k_len, *, sm_scale, dropout_rate=0.0,
                           dropout_seed=0, causal=False):
    """K1/K1-d (with ``causal`` K3-f/K3-d) on the simple design
    (csrc/flash_attention_fwd.cu) in every mode, the bf16 main paths'
    included: the baseline of the same-run A/B against the Hopper design.
    Counts on ``flash_attention.launches`` and ``.dropout_launches`` (with
    ``causal`` ``.causal_launches`` and ``.causal_dropout_launches``)."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    return fa._forward(q, k, v, k_len, sm_scale, dropout_rate, dropout_seed,
                       causal, design="simple")


def simple_flash_relpos_attention(q_u, q_v, k, v, p, k_len, *, sm_scale,
                                  dropout_rate=0.0, dropout_seed=0):
    """K4/K4-d on the simple design (csrc/flash_relpos_fwd.cu) in every
    mode, the bf16 main paths' included: the baseline of the same-run A/B
    against the Hopper design. Counts on ``flash_relpos_attention.launches``
    and ``.dropout_launches``."""
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    return fr._forward(q_u, q_v, k, v, p, k_len, sm_scale, dropout_rate,
                       dropout_seed, design="simple")


def kernels():
    """Id -> (call, plain version, the kernel's name, source, TPU kernel it
    replaces, (object, attribute) of its launch count). K1 and K4 are the
    simple design, which the main paths no longer take in bf16; K1-90 and
    K4-90 the Hopper design that they take (``flash_attention`` and
    ``flash_relpos_attention``, the names the models call in
    ops/attention.py)."""
    from transformer_tts_tpu_torch.ops import flash_attention as k1
    from transformer_tts_tpu_torch.ops import flash_relpos as k4
    jax_k1 = "transformer_tts_tpu/ops/flash_attention.py:90"
    return {
        "K1": (simple_flash_attention, k1.flash_attention_fwd_reference,
               k1.KERNEL, "transformer_tts_tpu_torch/csrc/"
               "flash_attention_fwd.cu", jax_k1,
               (k1.flash_attention, "launches")),
        "K1-90": (k1.flash_attention, k1.flash_attention_fwd_reference,
                  k1.SM90_KERNEL, "transformer_tts_tpu_torch/csrc/"
                  "flash_fwd_sm90.cu", jax_k1,
                  (k1.flash_attention, "sm90_launches")),
        "K4": (simple_flash_relpos_attention,
               k4.flash_relpos_attention_fwd_reference, k4.KERNEL,
               "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu",
               "transformer_tts_tpu/ops/flash_relpos.py:212",
               (k4.flash_relpos_attention, "launches")),
        "K4-90": (k4.flash_relpos_attention,
                  k4.flash_relpos_attention_fwd_reference, k4.SM90_KERNEL,
                  "transformer_tts_tpu_torch/csrc/flash_relpos_fwd_sm90.cu",
                  "transformer_tts_tpu/ops/flash_relpos.py:212",
                  (k4.flash_relpos_attention, "sm90_launches")),
    }


def train_kernels():
    """Id -> (object holding the launch count, its attribute, the entry's
    name in the kernels line, source, TPU kernel it replaces) for the
    kernels of the training path."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd90 = "transformer_tts_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd90 = "transformer_tts_tpu_torch/csrc/flash_bwd_sm90.cu"
    rp_fwd = "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu"
    rp_bwd = "transformer_tts_tpu_torch/csrc/flash_relpos_bwd.cu"
    rp_fwd90 = "transformer_tts_tpu_torch/csrc/flash_relpos_fwd_sm90.cu"
    rp_bwd90 = "transformer_tts_tpu_torch/csrc/flash_relpos_bwd_sm90.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    jax_rp = "transformer_tts_tpu/ops/flash_relpos.py"
    return {
        # the FastSpeech 2 step's kernels: the Hopper design, then the
        # simple one (the A/B's baseline; the fp32 card-vs-CPU step's)
        "K1-d-90": (fa.flash_attention, "sm90_dropout_launches",
                    "flash_fwd_sm90 dropout", fwd90, f"{jax_fa}:90"),
        "K2-90": (fa.flash_attention_bwd_sm90, "launches",
                  "flash_bwd_sm90 (dq, dk, dv fused)", bwd90,
                  f"{jax_fa}:266"),
        "K1-d": (fa.flash_attention, "dropout_launches",
                 "flash_attention_fwd dropout", fwd, f"{jax_fa}:90"),
        "K2-dq": (fa.flash_attention_bwd_dq, "launches",
                  "flash_attention_bwd dq", bwd, f"{jax_fa}:266"),
        "K2-dkdv": (fa.flash_attention_bwd_dkdv, "launches",
                    "flash_attention_bwd dk/dv", bwd, f"{jax_fa}:344"),
        # K3, the causal mode of the same kernels (the AR decoder): the
        # Hopper design the AR paths run in bf16, then the simple one (the
        # A/B's baseline; the fp32 card-vs-CPU step's)
        "K3-f-90": (fa.flash_attention, "sm90_causal_launches",
                    "flash_fwd_sm90 causal", fwd90, f"{jax_fa}:90"),
        "K3-d-90": (fa.flash_attention, "sm90_causal_dropout_launches",
                    "flash_fwd_sm90 causal dropout", fwd90, f"{jax_fa}:90"),
        "K3-90": (fa.flash_attention_bwd_sm90, "causal_launches",
                  "flash_bwd_sm90 causal (dq, dk, dv fused)", bwd90,
                  f"{jax_fa}:266"),
        "K3-f": (fa.flash_attention, "causal_launches",
                 "flash_attention_fwd causal", fwd, f"{jax_fa}:138"),
        "K3-d": (fa.flash_attention, "causal_dropout_launches",
                 "flash_attention_fwd causal dropout", fwd, f"{jax_fa}:138"),
        "K3-dq": (fa.flash_attention_bwd_dq, "causal_launches",
                  "flash_attention_bwd causal dq", bwd, f"{jax_fa}:306"),
        "K3-dkdv": (fa.flash_attention_bwd_dkdv, "causal_launches",
                    "flash_attention_bwd causal dk/dv", bwd,
                    f"{jax_fa}:379"),
        # the conformer decoder: K4 with dropout, and its backward K5, on
        # the Hopper design it runs in bf16 (the fused K5-90: the TPU's
        # _fused_bwd_kernel, _dq_kernel and _dkdv_kernel in one), then on
        # the simple one (the A/B's baseline; the fp32 card-vs-CPU step's)
        "K4-d-90": (fr.flash_relpos_attention, "sm90_dropout_launches",
                    "flash_relpos_fwd_sm90 dropout", rp_fwd90,
                    f"{jax_rp}:212"),
        "K5-90": (fr.flash_relpos_attention_bwd_sm90, "launches",
                  "flash_relpos_bwd_sm90 (dq_u, dq_v, dk, dv, dP fused)",
                  rp_bwd90, f"{jax_rp}:510"),
        "K4-d": (fr.flash_relpos_attention, "dropout_launches",
                 "flash_relpos_fwd dropout", rp_fwd, f"{jax_rp}:212"),
        "K5-dq": (fr.flash_relpos_attention_bwd_dq, "launches",
                  "flash_relpos_bwd dq", rp_bwd, f"{jax_rp}:360"),
        "K5-dkdv": (fr.flash_relpos_attention_bwd_dkdv, "launches",
                    "flash_relpos_bwd dk/dv/dP", rp_bwd, f"{jax_rp}:431"),
    }


def bias_kernels():
    """Id -> (object holding the launch count, its attribute, the entry's
    name in the kernels line, source, TPU kernel it replaces) for K6, the
    additive-bias mode of K1's and K2's sources, which no model path runs:
    chip_smoke drives it on the conformer's route that builds the relative
    bias in device memory (phase 7's route A/B). The Hopper design's K6-90,
    K6-d-90 and fused K6-bwd-90 run that route in bf16; the simple design's
    K6, K6-d, K6-dq and K6-dkdv run fp32 and the same-run A/B."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    fwd90 = "transformer_tts_tpu_torch/csrc/flash_fwd_sm90.cu"
    bwd90 = "transformer_tts_tpu_torch/csrc/flash_bwd_sm90.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    return {
        "K6-90": (fa.flash_attention_with_bias, "sm90_launches",
                  "flash_fwd_sm90 bias", fwd90, f"{jax_fa}:132"),
        "K6-d-90": (fa.flash_attention_with_bias, "sm90_dropout_launches",
                    "flash_fwd_sm90 bias dropout", fwd90, f"{jax_fa}:132"),
        "K6-bwd-90": (fa.flash_attention_bwd_sm90, "bias_launches",
                      "flash_bwd_sm90 bias (dq, dk, dv, dbias fused)", bwd90,
                      f"{jax_fa}:323"),
        "K6": (fa.flash_attention_with_bias, "launches",
               "flash_attention_fwd bias", fwd, f"{jax_fa}:132"),
        "K6-d": (fa.flash_attention_with_bias, "dropout_launches",
                 "flash_attention_fwd bias dropout", fwd, f"{jax_fa}:132"),
        "K6-dq": (fa.flash_attention_bwd_dq, "bias_launches",
                  "flash_attention_bwd dq+dbias", bwd, f"{jax_fa}:323"),
        "K6-dkdv": (fa.flash_attention_bwd_dkdv, "bias_launches",
                    "flash_attention_bwd bias dk/dv", bwd, f"{jax_fa}:374"),
    }


def counters() -> dict:
    """Id -> (object, attribute) of every kernel's launch count."""
    out = {kid: entry[5] for kid, entry in kernels().items()}
    out.update({kid: entry[:2] for kid, entry in train_kernels().items()})
    out.update({kid: entry[:2] for kid, entry in bias_kernels().items()})
    return out


def read_counts() -> dict:
    return {kid: getattr(obj, attr) for kid, (obj, attr) in counters().items()}


def set_counts(values: dict):
    for kid, (obj, attr) in counters().items():
        setattr(obj, attr, values.get(kid, 0))


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """Least time for the work: the larger of its operations over the
    peak rate and its bytes over HBM's rate."""
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_bound_ms(kid, tensors, k_len) -> tuple:
    """K1: 4*H*T_q*sum_b(k_len[b])*d operations, q, k, v, o moved once;
    K4: 6*H*T*sum_b(k_len[b])*d operations (q_u.K^T, q_v.P^T, P.V), q_u,
    q_v, k, v, o and p moved once; both also lse and k_len."""
    relpos = kid.startswith("K4")
    q, k = tensors[0], tensors[2 if relpos else 1]
    b, h, t_q, d = q.shape
    keys = k_len.clamp(max=k.shape[2]).double().sum().item()
    per_key = 6.0 if relpos else 4.0
    moved = sum(x.numel() for x in tensors) + q.numel()     # inputs, o
    nbytes = moved * q.element_size() + b * h * t_q * 4 + k_len.numel() * 4
    return bound_ms(per_key * h * t_q * keys * d, nbytes, q.dtype)


# ---- phase 3: the kernels against their plain versions ----------------------

def kernel_errors(kid, tensors, k_len):
    """(err_o, err_lse) of the kernel against the fp32 plain version on the
    same inputs; fails unless rows with no valid key are exactly 0 and a
    second launch gives O bit for bit."""
    from transformer_tts_tpu_torch.ops.flash_attention import NEG_INF
    kernel, plain = kernels()[kid][:2]
    obj, attr = kernels()[kid][5]
    before = getattr(obj, attr)
    sm_scale = tensors[0].shape[-1] ** -0.5
    o, lse = kernel(*tensors, k_len, sm_scale=sm_scale)
    again, _ = kernel(*tensors, k_len, sm_scale=sm_scale)
    torch.cuda.synchronize()
    check(getattr(obj, attr) - before == 2,
          f"{kid}: the launches went to another kernel than {kid}'s")
    check(torch.equal(o, again), f"{kid}: a second launch gave another O")
    ro, rlse = plain(*(x.float() for x in tensors), k_len, sm_scale)
    empty = (k_len == 0)
    check(bool((o[empty] == 0).all()) and
          bool((lse[empty] == np.float32(NEG_INF)).all()),
          f"{kid}: rows with no valid key are not exactly 0 / -1e30")
    valid = ~empty
    err_o = (o.float() - ro)[valid].abs().max().item()
    err_lse = (lse - rlse)[valid].abs().max().item()
    return err_o, err_lse


def kernel_inputs(kid, gen, b, h, t_q, t_k, d):
    """Random inputs of the kernel's shapes, on the card, in fp32."""
    if not kid.startswith("K4"):
        shapes = [(b, h, t_q, d), (b, h, t_k, d), (b, h, t_k, d)]
    else:                               # q_u, q_v, k, v, p
        shapes = [(b, h, t_q, d)] * 4 + [(h, t_q, d)]
    return [torch.randn(s, generator=gen).to(DEVICE) for s in shapes]


def phase_kernel_vs_plain(gen):
    k1_cases = [(1, 4, 768, 768, 96, [768]),
                (8, 4, 2048, 2048, 96, [2048, 0, 1000, 1, 2047, 64, 65,
                                        1500]),
                (2, 4, 1000, 1000, 96, [1000, 333]),        # ragged T
                (2, 4, 300, 700, 96, [700, 0])]             # T_q != T_k
    k4_cases = [(1, 4, 768, 768, 96, [768]),
                (8, 4, 2048, 2048, 96, [2048, 0, 1, 64, 65, 2047, 1000,
                                        1500]),
                (2, 4, 1000, 1000, 96, [1000, 333]),        # ragged T
                (2, 4, 257, 257, 96, [257, 3])]             # just over 256
    cases = {  # (B, H, T_q, T_k, d, k_len)
        "K1": k1_cases,
        # the Hopper design takes bf16 only (fp32 goes to K1), and d = 64
        "K1-90": k1_cases + [(2, 4, 257, 257, 64, [257, 3])],
        "K4": k4_cases,
        "K4-90": k4_cases + [(2, 4, 511, 511, 64, [511, 65])],
    }
    for kid, kid_cases in cases.items():
        for b, h, t_q, t_k, d, k_len in kid_cases:
            tensors = kernel_inputs(kid, gen, b, h, t_q, t_k, d)
            kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
            for dtype, (tol_o, tol_lse) in TOLS.items():
                if kid.endswith("-90") and dtype != torch.bfloat16:
                    continue
                err_o, err_lse = kernel_errors(
                    kid, [x.to(dtype) for x in tensors], kl)
                print(f"{kid} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} k_len={k_len}: max|dO|={err_o:.3g} "
                      f"(tol {tol_o}) max|dlse|={err_lse:.3g} "
                      f"(tol {tol_lse})")
                check(err_o <= tol_o and err_lse <= tol_lse,
                      f"{kid} disagrees with its plain version at "
                      f"{(b, h, t_q, d)} {dtype}")
        for b, t in ((1, 768), (8, 2048)):     # the synthesis shapes
            tensors = [x.to(torch.bfloat16)
                       for x in kernel_inputs(kid, gen, b, 4, t, t, 96)]
            res = kernel_timings(kid, tensors, torch.full(
                (b,), t, dtype=torch.int32, device=DEVICE))
            print(f"{kid} ({b},4,{t},96) bf16 all keys: kernel "
                  f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                  f"library {res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']})")


# ---- phase 3, continued: the training kernels -------------------------------

DROPOUT_SEED = -123456789       # an int32 whose uint32 bits wrap
# fp32: products in FMAs, sums in another order; bf16: dS and P keep
# rounded to bf16 before their products, as the TPU kernels do
REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def max_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|) in fp32."""
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def train_kernel_ids(design: str, causal: bool, rate: float) -> tuple:
    """(forward id, backward ids) of the kernels a design runs for a mode:
    the Hopper design's K1/K1-d (K3-f/K3-d) and fused K2 (K3's), or the
    simple design's forward and its dq and dk/dv pair."""
    if design == "sm90":
        if causal:
            return ("K3-d-90" if rate else "K3-f-90"), ("K3-90",)
        return ("K1-d-90" if rate else "K1-90"), ("K2-90",)
    if causal:
        return ("K3-d" if rate else "K3-f"), ("K3-dq", "K3-dkdv")
    return ("K1-d" if rate else "K1"), ("K2-dq", "K2-dkdv")


def check_train_kernels(q, k, v, do, k_len, rate, seed=DROPOUT_SEED,
                        label="", causal=False, design=None) -> tuple:
    """K1/K1-d and K2 (with ``causal`` K3's forward and backward) on
    (q, k, v, do) against the plain versions in fp32 on the same inputs,
    on the design ``flash_attention`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline); the
    launches must have gone to that design's kernels for the mode (the
    forward twice, each backward kernel once), and a second forward launch
    must give O bit for bit. O, dq, dk and dv must agree within REL_TOL
    times that tensor's own max |ref| (the gradients reaching the
    decoder's attention in training are ~1e-7), lse within TOLS' absolute
    limit; dk and dv exactly 0 for keys at or past k_len. Returns ({name:
    max abs err}, {name: max |ref|}, o). Launch counts are left as they
    were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    chosen = design or fa.select_design(q.dtype, False, q.shape[-1])
    fwd, bwd_ids = train_kernel_ids(chosen, causal, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
              causal=causal)
    with torch.no_grad():
        if design == "simple":
            forward = partial(simple_flash_attention, q, k, v, k_len,
                              sm_scale=sm_scale, dropout_rate=rate,
                              dropout_seed=seed, causal=causal)
            o, lse = forward()
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, do, lse, delta, k_len)
            grads = (fa.flash_attention_bwd_dq(*args, **kw),
                     *fa.flash_attention_bwd_dkdv(*args, **kw))
        else:
            forward = partial(fa.flash_attention, q, k, v, k_len,
                              dropout_rate=rate, dropout_seed=seed,
                              causal=causal)
            o, lse = forward()
            grads = fa.flash_attention_bwd(q, k, v, o, lse, do, k_len, **kw)
        again, _ = forward()
        torch.cuda.synchronize()
        check(torch.equal(o, again), f"{fwd}{label}: a second launch gave "
                                     f"another O")
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 1 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, "
                             f"not {want}")
        f = [x.float() for x in (q, k, v)]
        ro, rlse = fa.flash_attention_fwd_reference(*f, k_len, sm_scale,
                                                    rate, seed, causal)
        ref = fa.flash_attention_bwd_reference(*f, o.float(), lse,
                                               do.float(), k_len, sm_scale,
                                               rate, seed, causal)
    set_counts(counts)
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    for name, g in (("dk", grads[1]), ("dv", grads[2])):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b, :, n:] == 0).all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or "
                  f"past k_len")
    return errs, peaks, o


def phase_train_kernels_vs_plain(gen, train_k_len):
    """K1-d and K2 against their plain versions: k_len in {0, 1, 65, T},
    ragged T = 1000, T_q = 300 != T_k = 700, and the train step's shape
    (16, 4, 1024, 96) with k_len in {0, 1, 65, T}, with T_q = 768 != T_k,
    and with its batch's mel lengths as k_len; fp32 (TF32 off, the simple
    kernels) and bf16 (the Hopper design, then the simple one); dropout 0
    and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    edge = [t_train, 0, 1, 65] * (b_train // 4)
    cases = [(4, 4, 1000, 1000, 96, [1000, 0, 1, 65]),
             (2, 4, 300, 700, 96, [700, 65]),
             (b_train, 4, t_train, t_train, 96, edge),
             (b_train, 4, 768, t_train, 96, edge),
             (b_train, 4, t_train, t_train, 96, train_k_len.tolist())]
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype, design in ((torch.float32, None), (torch.bfloat16, None),
                              (torch.bfloat16, "simple")):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate,
                    design=design)
                name = ("K1-d/K2 simple" if dtype == torch.float32
                        or design else "K1-d/K2 sm90")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if len(set(k_len)) <= 4 else 'the train batch'}"
                      ": " + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                      f"{peaks[n]:.3g})"
                                      for n, e in errs.items()))


AR_GROUPS = 511                 # decoder groups at the 1024-frame bucket


def phase_causal_kernels_vs_plain(gen, ar_k_len):
    """K3 (the causal forward at rates 0 and 0.1, its dq and dk/dv)
    against its plain versions: (16, 4, 511, 96), the AR train step's
    shape, with k_len in {T, 0, 1, 65} and the rest of the rows the AR
    batch's decoder groups; T_q != T_k both ways; d = 64; fp32 (TF32 off,
    the simple kernels) and bf16 on both designs (the Hopper one, K3-f-90
    or K3-d-90 and the fused K3-90, then the simple one), O, dq, dk and
    dv each within REL_TOL of its own max|ref|, lse as K1's; dk and dv
    exactly 0 past k_len; O bit for bit on a second launch; each launch
    on its id's counter."""
    b_train = TRAIN_BATCH[0]
    k_len = ([AR_GROUPS, 0, 1, 65] + ar_k_len.tolist())[:b_train]
    cases = [(b_train, 4, AR_GROUPS, AR_GROUPS, 96, k_len),
             (2, 4, 300, 700, 96, [700, 65]),
             (2, 4, 700, 300, 96, [300, 1]),
             (4, 4, 300, 300, 64, [300, 0, 1, 65])]
    for b, h, t_q, t_k, d, kl in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(kl, dtype=torch.int32, device=DEVICE)
        for dtype, design in ((torch.float32, None), (torch.bfloat16, None),
                              (torch.bfloat16, "simple")):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate,
                    causal=True, design=design)
                name = ("K3 simple" if dtype == torch.float32 or design
                        else "K3 sm90")
                cases_k = (kl.tolist() if b <= 4
                           else "T, 0, 1, 65 and the AR batch's")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len={cases_k}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


RELPOS_GRADS = ("dq_u", "dq_v", "dk", "dv", "dp")


def relpos_kernel_ids(design: str, rate: float) -> tuple:
    """(forward id, backward ids) of the relative kernels a design runs:
    the Hopper design's K4-90/K4-d-90 and fused K5-90, or the simple
    design's K4/K4-d and its dq and dk/dv/dP pair."""
    if design == "sm90":
        return ("K4-d-90" if rate else "K4-90"), ("K5-90",)
    return ("K4-d" if rate else "K4"), ("K5-dq", "K5-dkdv")


def check_relpos_train_kernels(q_u, q_v, k, v, p, do, k_len, rate,
                               seed=DROPOUT_SEED, label="",
                               design=None) -> tuple:
    """K4 (rate 0) or K4-d and K5 on (q_u, q_v, k, v, p, do) against their
    plain versions in fp32 on the same inputs, on the design
    ``flash_relpos_attention`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline): the
    launches must have gone to that design's kernels (the forward twice,
    each backward kernel once); O, dq_u, dq_v, dk, dv and dp each within
    REL_TOL of its own max|ref|, lse within TOLS' absolute limit; dk and
    dv exactly 0 for keys at or past k_len; O bit for bit the same on a
    second call with the same seed. Returns ({name: max abs err}, {name:
    max|ref|}, o). Launch counts are left as they were."""
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    chosen = design or fr._design(q_u, q_v, k, v, p, (do,))
    fwd, bwd_ids = relpos_kernel_ids(chosen, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q_u.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    call = (partial(simple_flash_relpos_attention, sm_scale=sm_scale)
            if design == "simple" else fr.flash_relpos_attention)
    with torch.no_grad():
        o, lse = call(q_u, q_v, k, v, p, k_len, **kw)
        o_again, _ = call(q_u, q_v, k, v, p, k_len, **kw)
        grads = fr.flash_relpos_attention_bwd(q_u, q_v, k, v, p, o, lse, do,
                                              k_len, sm_scale=sm_scale,
                                              design=design, **kw)
        torch.cuda.synchronize()
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 1 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, not "
                             f"{want}")
        f = [x.float() for x in (q_u, q_v, k, v, p)]
        ro, rlse = fr.flash_relpos_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed)
        ref = fr.flash_relpos_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed)
    set_counts(counts)
    check(torch.equal(o, o_again), f"{fwd}{label}: another O on a second "
                                   f"call with the same seed")
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q_u.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q_u.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(RELPOS_GRADS, grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    for name, g in (("dk", grads[2]), ("dv", grads[3])):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b, :, n:] == 0).all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or "
                  f"past k_len")
    return errs, peaks, o


RELPOS_T = (1024, 1000, 511)    # E's window alignment depends on T mod 64


def phase_relpos_kernels_vs_plain(gen, train_k_len):
    """K4/K4-d and K5 against their plain versions: k_len in {0, 1, 65, T}
    at T in RELPOS_T and d in {64, 96}, in bf16 on both designs (the
    Hopper one, K4-90 or K4-d-90 and the fused K5-90, then the simple
    one); at T = 1000, d = 96 also fp32 (TF32 off, the simple kernels);
    and the conformer train step's shape (16, 4, 1024, 96) with its
    batch's mel lengths as k_len in fp32 and on both bf16 designs;
    dropout 0 and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    cases = [(4, 4, t, d, [t, 0, 1, 65]) for t in RELPOS_T for d in (96, 64)]
    cases.append((b_train, 4, t_train, 96, train_k_len.tolist()))
    for b, h, t, d, k_len in cases:
        q_u, q_v, k, v, do = (torch.randn(b, h, t, d, generator=gen)
                              .to(DEVICE) for _ in range(5))
        p = torch.randn(h, t, d, generator=gen).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        modes = [(torch.bfloat16, None), (torch.bfloat16, "simple")]
        if (t, d) == (1000, 96) or b > 4:
            modes.insert(0, (torch.float32, None))
        for dtype, design in modes:
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_relpos_train_kernels(
                    *(x.to(dtype) for x in (q_u, q_v, k, v, p, do)), kl,
                    rate, design=design)
                name = ("K4/K5 simple" if dtype == torch.float32 or design
                        else "K4/K5 sm90")
                print(f"{name} vs plain ({b},{h},{t},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if b <= 4 else 'the train batch'}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


BIAS_GRADS = ("dq", "dk", "dv", "dbias")


def bias_kernel_ids(design: str, rate: float) -> tuple:
    """(forward id, backward ids) of the K6 kernels a design runs: the
    Hopper design's K6-90/K6-d-90 and fused K6-bwd-90, or the simple
    design's K6/K6-d and its dq+dbias and dk/dv pair."""
    if design == "sm90":
        return ("K6-d-90" if rate else "K6-90"), ("K6-bwd-90",)
    return ("K6-d" if rate else "K6"), ("K6-dq", "K6-dkdv")


def check_bias_kernels(q, k, v, bias, do, k_len, rate, seed=DROPOUT_SEED,
                       label="", design=None) -> tuple:
    """K6 (rate 0) or K6-d and K6's backward on (q, k, v, bias, do) against
    their plain versions in fp32 on the same inputs, on the design
    ``flash_attention_with_bias`` picks for the mode, or with
    ``design="simple"`` on the simple kernels (the A/B's baseline): the
    forward and the backward each run twice, and the launches must have
    gone to that design's kernels. O, dq, dk, dv and dbias each within
    REL_TOL of its own max|ref|, lse within TOLS' absolute limit; dbias,
    dk and dv exactly 0 for keys at or past k_len (dbias on every row); O,
    dk, dv and dbias bit for bit the same on the second call with the same
    seed (dq sums with atomics in the Hopper design). Returns ({name: max
    abs err}, {name: max|ref|}, o). Launch counts are left as they
    were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    chosen = design or fa._design(q, k, v, bias, (do,))
    fwd, bwd_ids = bias_kernel_ids(chosen, rate)
    bwd = "/".join(bwd_ids)
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    bkw = dict(sm_scale=sm_scale, bias=bias, **kw)
    with torch.no_grad():
        if design == "simple":
            forward = partial(fa._forward, q, k, v, k_len, sm_scale, rate,
                              seed, False, bias, design="simple")
        else:
            forward = partial(fa.flash_attention_with_bias, q, k, v, bias,
                              k_len, **kw)
        o, lse = forward()
        o_again, _ = forward()
        if design == "simple":
            delta = fa.bwd_delta(o, do)
            args = (q, k, v, do, lse, delta, k_len)

            def backward():
                dq, dbias = fa.flash_attention_bwd_dq(*args, **bkw)
                return (dq, *fa.flash_attention_bwd_dkdv(*args, **bkw),
                        dbias)
        else:
            backward = partial(fa.flash_attention_bwd, q, k, v, o, lse, do,
                               k_len, **bkw)
        grads = backward()
        again = backward()
        torch.cuda.synchronize()
        moved = {kid: n - counts[kid] for kid, n in read_counts().items()
                 if n != counts[kid]}
        want = {fwd: 2, **{kid: 2 for kid in bwd_ids}}
        check(moved == want, f"{fwd}/{bwd}{label}: launches {moved}, not "
                             f"{want}")
        f = [x.float() for x in (q, k, v)]
        ro, rlse = fa.flash_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed, bias=bias.float())
        ref = fa.flash_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed,
            bias=bias.float())
    set_counts(counts)
    check(torch.equal(o, o_again), f"{fwd}{label}: another O on a second "
                                   f"call with the same seed")
    for name, a, b in zip(BIAS_GRADS[1:], grads[1:], again[1:]):
        check(torch.equal(a, b), f"{bwd} {name}{label}: another result on "
                                 f"a second call")
    empty = k_len == 0
    check(bool((o[empty] == 0).all()), f"{fwd}{label}: a row with no valid "
                                       f"key is not 0")
    errs, peaks = {}, {}
    errs["o"], peaks["o"] = max_err(o[~empty], ro[~empty])
    errs["lse"], peaks["lse"] = max_err(lse[~empty], rlse[~empty])
    rel = REL_TOL[q.dtype]
    check(errs["o"] <= rel * peaks["o"] and errs["lse"] <= TOLS[q.dtype][1],
          f"{fwd}{label} disagrees with its plain version: {errs} against "
          f"max|ref| {peaks}")
    for name, got, want in zip(BIAS_GRADS, grads, ref):
        errs[name], peaks[name] = max_err(got, want)
        check(errs[name] <= rel * peaks[name],
              f"{bwd} {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    check(grads[3].dtype == bias.dtype, f"{bwd} dbias{label} is not in the "
                                        f"bias's dtype")
    for name, g, axis in (("dk", grads[1], 2), ("dv", grads[2], 2),
                          ("dbias", grads[3], 3)):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b].narrow(axis - 1, n, g.shape[axis] - n) == 0)
                       .all()),
                  f"{bwd} {name}{label} is not exactly 0 for keys at or past "
                  f"k_len")
    return errs, peaks, o


BIAS_T = (1000, 1024)   # a ragged last key tile, then none


def phase_bias_kernels_vs_plain(gen):
    """K6/K6-d and K6's backward against their plain versions: k_len in
    {0, 1, 65, T} at T = 1000 and 1024, d in {64, 96}, in bf16 on both
    designs (the Hopper one, K6-90 or K6-d-90 and the fused K6-bwd-90,
    then the simple one, K6 or K6-d and dq+dbias, dk/dv); at T = 1000, d =
    96 also fp32 (TF32 off, the simple kernels); and T_q = 300 != T_k =
    700, whose T_k is not a multiple of 8, so the rule sends bf16 to the
    simple kernels (which read its bias tiles element by element), fp32
    and bf16; dropout 0 and 0.1 on the same seed; a random bias of scale
    2."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    cases = [(4, 4, t, t, d, [t, 0, 1, 65]) for t in BIAS_T
             for d in (96, 64)]
    cases.append((2, 4, 300, 700, 96, [700, 65]))
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        bias = (2 * torch.randn(b, h, t_q, t_k, generator=gen)).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        rule = fa._design(*(x.to(torch.bfloat16) for x in (q, k, v)),
                          bias.to(torch.bfloat16))
        check(rule == ("sm90" if t_k % 8 == 0 else "simple"),
              f"the design rule sends a bf16 bias of T_k = {t_k} to {rule}")
        modes = [(torch.bfloat16, None)]
        if rule == "sm90":
            modes.append((torch.bfloat16, "simple"))
        if (t_q, d) == (BIAS_T[0], 96) or rule == "simple":
            modes.insert(0, (torch.float32, None))
        for dtype, design in modes:
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_bias_kernels(
                    *(x.to(dtype) for x in (q, k, v, bias, do)), kl, rate,
                    design=design)
                name = ("K6 sm90" if dtype == torch.bfloat16 and not design
                        and rule == "sm90" else "K6 simple")
                print(f"{name} vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len={k_len}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


def relpos_bias(q_v, p, k_len, sm_scale):
    """rel_shift(q_v P^T) * sm_scale with -inf past k_len, in q_v's dtype:
    the additive mask of K4's library yardstick."""
    from transformer_tts_tpu_torch.ops.flash_relpos import rel_shift
    bias = rel_shift(torch.matmul(q_v, p.transpose(-1, -2))) * sm_scale
    valid = (torch.arange(q_v.shape[2], device=q_v.device)[None, :]
             < k_len[:, None])[:, None, None, :]
    return bias.masked_fill(~valid, float("-inf"))


def kernel_timings(kid, tensors, k_len) -> dict:
    """Kernel, plain version and library times on the same inputs, the
    bound and the kernel's error against the fp32 plain version. K1's
    library call is SDPA with the key mask; K4's is SDPA with the
    relative bias precomputed, whose build is timed apart (bias_ms)."""
    import torch.nn.functional as F
    kernel, plain = kernels()[kid][:2]
    sm_scale = tensors[0].shape[-1] ** -0.5
    counts = read_counts()
    res = {
        "ms": time_ms(lambda: kernel(*tensors, k_len, sm_scale=sm_scale)),
        "plain_ms": time_ms(lambda: plain(*tensors, k_len, sm_scale)),
    }
    if not kid.startswith("K4"):
        q, k, v = tensors
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                < k_len[:, None])[:, None, None, :]
    else:
        q, q_v, k, v, p = tensors
        mask = relpos_bias(q_v, p, k_len, sm_scale)
        res["bias_ms"] = time_ms(lambda: relpos_bias(q_v, p, k_len,
                                                     sm_scale))
    res["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=sm_scale))
    res["bound_ms"], res["bound_by"] = kernel_bound_ms(kid, tensors, k_len)
    res["max_abs_err"] = kernel_errors(kid, tensors, k_len)[0]
    set_counts(counts)      # these launches are not the main path's
    return res


# ---- phase 4: the full-width slices -----------------------------------------

def flagship_model(device, amp: bool, stacks: dict, seed: int = 0):
    from transformer_tts_tpu_torch.config import HParams
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    # d 384, 6+6 layers, 4 heads, vocab 152, mel 80
    hp = HParams(**dict(FLAGSHIP, **stacks, amp=amp))
    model = build_fastspeech2(hp, device=device, seed=seed).eval()
    with torch.no_grad():
        # random weights then give ~6 frames per phone
        model.variance_adaptor.duration_predictor.linear_layer.bias.fill_(
            math.log(1.0 + 6.0))
    return hp, model


def text_batch(gen, batch: int, length: int, min_len: int, vocab: int):
    lens = torch.linspace(length, min_len, batch).round().long()
    text = torch.randint(1, vocab, (batch, length), generator=gen)
    pos = torch.arange(1, length + 1)[None].repeat(batch, 1)
    pos = torch.where(pos <= lens[:, None], pos, torch.zeros_like(pos))
    return torch.where(pos > 0, text, torch.zeros_like(text)), pos


def phase_teacher_forced(gen, name, stacks):
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    hp, cpu_model = flagship_model("cpu", amp=False, stacks=stacks)
    text, pos = text_batch(gen, 2, 128, 100, hp.vocab_size)
    t = 768
    d = torch.randint(2, 8, text.shape, generator=gen) * (text != 0)
    p = torch.rand(2, t, generator=gen) * 740 + 60
    e = torch.rand(2, t, generator=gen) * 315
    inputs = (text, pad_mask(pos), t, d, p, e)

    with torch.no_grad():
        ref = cpu_model(*inputs)
    _, model = flagship_model(DEVICE, amp=False, stacks=stacks)
    cuda_inputs = [x.to(DEVICE) if torch.is_tensor(x) else x for x in inputs]
    for amp in (False, True):
        model.amp = amp
        with torch.no_grad():
            out = model(*cuda_inputs)
        check(torch.equal(out.mel_len.cpu(), ref.mel_len),
              f"{name} teacher-forced mel_len differs between card and CPU")
        errs = []
        for b, n in enumerate(ref.mel_len.tolist()):
            diff = out.mel_post[b, :n].float().cpu() - ref.mel_post[b, :n]
            errs.append(diff.abs().max().item())
        peak = ref.mel_post.abs().max().item()
        tol = 5e-2 * max(1.0, peak) if amp else 1e-3
        label = "bf16 amp" if amp else "fp32"
        print(f"{name} teacher-forced forward B=2 L=128 T={t}: card {label} "
              f"vs CPU fp32: max|d mel_post| = {max(errs):.3g} (tol "
              f"{tol:.3g}, max|ref| = {peak:.3g}, frames "
              f"{ref.mel_len.tolist()})")
        check(max(errs) <= tol, f"{name}: card {label} forward disagrees "
                                f"with CPU")


@contextmanager
def capture_calls(module, name: str, store: list):
    """Append (args, kwargs) of every call of ``module.name`` to ``store``,
    the tensors as detached copies; the call still goes to the real
    function, whose launches count."""
    real = getattr(module, name)

    def recording(*args, **kw):
        store.append((tuple(x.detach().clone() if torch.is_tensor(x) else x
                            for x in args), dict(kw)))
        return real(*args, **kw)

    setattr(module, name, recording)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_synthesis(gen, name, stacks, kid):
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    from transformer_tts_tpu_torch.ops import attention
    hp, model = flagship_model(DEVICE, amp=True, stacks=stacks)
    cases = [(1, 768), (8, 2048)]
    batches = []
    for batch, max_frames in cases:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.to(DEVICE), pos.to(DEVICE), max_frames))

    captured = []
    set_counts({})                          # the main path starts here
    per_call = {k: [] for k in counters()}
    with capture_calls(attention, kernels()[kid][0].__name__, captured):
        for text, pos, max_frames in batches:
            captured.clear()
            before = read_counts()
            mel, mel_len, dur = synthesize_fastspeech2(model, text, pos,
                                                       max_frames)
            torch.cuda.synchronize()
            for k, n in read_counts().items():
                per_call[k].append(n - before[k])
            check(mel.shape == (text.shape[0], max_frames, hp.mel_dim),
                  f"{name}: mel shape {tuple(mel.shape)}")
            check(bool(torch.isfinite(mel.float()).all()),
                  f"{name}: non-finite mel")
            check(int(mel_len.min()) > 0, f"{name}: empty mel_len")
    launches = read_counts()                # it ends here
    print(f"{name} main path: launches per synthesis call "
          f"{json.dumps(per_call)} (expect {hp.n_layer_decoder} of {kid} "
          f"each, none of the others), total {json.dumps(launches)}")
    check(all(n == hp.n_layer_decoder for n in per_call[kid]),
          f"{name}: {kid} did not launch once per decoder layer")
    check(all(n == 0 for k, n in launches.items() if k != kid),
          f"{name}: a kernel of another path launched")
    main_inputs = captured[0][0]    # the B=8 / 2048-frame call's layer 0

    for text, pos, max_frames in batches:
        def call():
            out = synthesize_fastspeech2(model, text, pos, max_frames)
            torch.cuda.synchronize()
            return out
        for _ in range(3):
            call()
        walls = []
        for _ in range(10):
            t0 = time.perf_counter()
            _, mel_len, _ = call()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(walls)
        audio_s = mel_len.sum().item() * HOP_SECONDS
        rtf = ms / 1e3 / audio_s
        print(f"{name} synthesize_fastspeech2 B={text.shape[0]} L=128 "
              f"max_frames={max_frames} bf16 amp: {ms:.3f} ms/call "
              f"(median of 10), {mel_len.sum().item()} frames = "
              f"{audio_s:.3f} s audio, RTF {rtf:.6f}")
    return hp, model, launches, main_inputs


def phase_cli(name, stacks, hp, model):
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
    work = os.path.join(WORK, name)
    model_dir = os.path.join(work, "model")
    out_dir = os.path.join(work, "generated")
    os.makedirs(model_dir, exist_ok=True)
    save_checkpoint(model, model_dir)
    script = os.path.join(work, "test.txt")
    rs = np.random.RandomState(0)
    lines = [" ".join(str(i) for i in rs.randint(1, hp.vocab_size, n))
             for n in (40, 90, 128)]
    with open(script, "w") as fh:
        fh.write("".join(f"utt{i}.npy|{s}\n" for i, s in enumerate(lines)))
    with open(os.path.join(model_dir, "hparams.py"), "w") as fh:
        for key, value in dict(FLAGSHIP, **stacks,
                               test_script=script).items():
            fh.write(f"{key} = {value!r}\n")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.synthesize",
         "--load_name", model_dir, "--save", out_dir, "--max_frames",
         "2048", "--device", DEVICE], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    print(proc.stdout.strip())
    check(proc.returncode == 0, f"{name} CLI exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    for i, n_text in enumerate((40, 90, 128)):
        mel = np.load(os.path.join(out_dir, f"{i}.npy"))
        align = np.load(os.path.join(out_dir, f"{i}_alignment.npy"))
        check(mel.dtype == np.float32 and mel.ndim == 2
              and mel.shape[1] == hp.mel_dim
              and 0 < mel.shape[0] <= 2048
              and bool(np.isfinite(mel).all()),
              f"{name} CLI mel {i} {mel.shape}")
        check(mel.shape[0] == min(2048, int(align.sum()))
              and align.shape[0] >= n_text, f"{name} CLI alignment {i}")
    print(f"{name} CLI: 3 utterances written and checked")


# ---- the profile ------------------------------------------------------------

# CUPTI's own activity records, which are no work of the program
CUPTI_OVERHEAD = ("Lazy Function Loading", "Activity Buffer Request")
# profiles queued by the phases, each building what it profiles anew, run
# after every timed phase: a profiler pass slows the host work of the rest
# of its process (train_step_ab.py times steps before and after one), so
# no timing may follow one, and nothing is held on the card meanwhile
PROFILES = []


def print_profile(label: str, fn, n: int, ms_per_run: float):
    """Run ``fn`` ``n`` times under torch.profiler (CPU and CUDA activity)
    and print the ten device operations (kernels, copies, memsets) with
    the most self time on the card, each with its share of the device
    time and its launches per run; user annotations (whose device range
    covers kernels counted already) and CUPTI's overhead records are left
    out. The device's busy time per run stands against ``ms_per_run``,
    the same work's time measured without the profiler in this run, for
    the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and device_us(e) > 0
           and not getattr(e, "is_user_annotation", False)
           and e.key not in CUPTI_OVERHEAD]
    busy_ms = sum(device_us(e) for e in ops) / 1e3 / n
    check(busy_ms > 0, f"{label}: the profile holds no device time")
    print(f"profile of {label}, {n} run(s): device busy {busy_ms:.3f} ms "
          f"per run against {ms_per_run:.3f} ms measured without the "
          f"profiler ({max(0.0, 1 - busy_ms / ms_per_run):.1%} idle); top 10 "
          f"device operations (ms per run, share of device time, launches "
          f"per run):")
    for e in sorted(ops, key=device_us, reverse=True)[:10]:
        ms = device_us(e) / 1e3 / n
        print(f"  {ms:9.4f} ms {ms / busy_ms:6.1%} {e.count / n:8.1f}x "
              f"{e.key[:110]}")
    return ops


# ---- phase 5: training ------------------------------------------------------

TRAIN_BATCH = (16, 128, 1024, (600, 1000))   # B, text bucket, mel bucket,
                                             # range of frames per row
CPU_STEP_BATCH = (2, 128, 768, (500, 760))
CLI_CORPUS = (32, (300, 900), 8)             # utterances, frames, batch


def train_batch(gen, hp, b, text_len, mel_len, frames, device):
    """A collated training batch: text lengths from text_len down to half
    of it, durations per row summing to a total drawn from ``frames``,
    random mel, f0 and energy on the valid frames, the collate's pads."""
    lens = torch.linspace(text_len, text_len // 2, b).round().long()
    text = torch.zeros(b, text_len, dtype=torch.int32)
    dur = torch.zeros(b, text_len, dtype=torch.int32)
    totals = torch.randint(frames[0], frames[1] + 1, (b,), generator=gen)
    for i, (n, total) in enumerate(zip(lens.tolist(), totals.tolist())):
        text[i, :n] = torch.randint(1, hp.vocab_size, (n,), generator=gen,
                                    dtype=torch.int32)
        w = torch.rand(n, generator=gen) + 0.5
        d = (w / w.sum() * total).floor().int()
        d[: total - int(d.sum())] += 1
        dur[i, :n] = d
    pos = torch.arange(1, text_len + 1)[None]
    pos_text = torch.where(text != 0, pos, 0).int()
    pos_mel = torch.where(torch.arange(1, mel_len + 1)[None]
                          <= totals[:, None],
                          torch.arange(1, mel_len + 1)[None], 0).int()
    valid = pos_mel > 0
    mel = torch.where(valid[..., None],
                      torch.randn(b, mel_len, hp.mel_dim, generator=gen),
                      torch.full((), -5.0))
    f0 = torch.where(valid, torch.rand(b, mel_len, generator=gen) * 740 + 60,
                     0.0)
    energy = torch.where(valid, torch.rand(b, mel_len, generator=gen) * 315,
                         0.0)
    batch = dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                 alignment=dur, f0=f0, energy=energy)
    return {k: v.to(device) for k, v in batch.items()}


def train_hparams(**overrides):
    """The transformer flagship (d 384, 6+6 layers, 4 heads of 96, bf16
    amp, dropout 0.1, Noam with warmup 4000, clip 1.0) with overrides."""
    from transformer_tts_tpu_torch.config import HParams
    return HParams(**dict(FLAGSHIP, **overrides))


def ar_hparams(**overrides):
    """The AR Transformer-TTS flagship of egs/transformer_tts_ljspeech.py
    (the defaults with model = "Transformer": d 384, 6+6 layers, 4 heads
    of 96, FFN kernels 5/1, r 2, bf16 amp, dropout 0.1, prenet dropout
    0.5, Noam with warmup 4000, clip 1.0, positive_weight 5) with
    overrides."""
    return train_hparams(**dict(overrides, model="Transformer"))


def ar_train_batch(gen, hp, b, text_len, mel_len, frames, device):
    """A collated AR batch: text as ``train_batch``'s; per row a zero go
    frame, then random mel, a count of frames (go frame included) drawn
    from ``frames``; pos_mel over that count rounded up to r, the mel pad
    -5.0 and stop_token 1.0 past the row's frames, as the collate pads."""
    r = hp.reduction_rate
    lens = torch.linspace(text_len, text_len // 2, b).round().long()
    text = torch.zeros(b, text_len, dtype=torch.int32)
    mel = torch.full((b, mel_len, hp.mel_dim), -5.0)
    stop = torch.ones(b, mel_len)
    totals = torch.randint(frames[0], frames[1] + 1, (b,), generator=gen)
    for i, (n, total) in enumerate(zip(lens.tolist(), totals.tolist())):
        text[i, :n] = torch.randint(1, hp.vocab_size, (n,), generator=gen,
                                    dtype=torch.int32)
        mel[i, 0] = 0.0
        mel[i, 1:total] = torch.randn(total - 1, hp.mel_dim, generator=gen)
        stop[i, :total] = 0.0
    rounded = -(-totals // r) * r
    pos = torch.arange(1, mel_len + 1)[None]
    pos_text = torch.where(text != 0, torch.arange(1, text_len + 1)[None],
                           0).int()
    pos_mel = torch.where(pos <= rounded[:, None], pos, 0).int()
    batch = dict(text=text, pos_text=pos_text, mel=mel, pos_mel=pos_mel,
                 stop_token=stop)
    return {k: v.to(device) for k, v in batch.items()}


def conformer_hparams(**overrides):
    """The conformer flagship of egs/fastspeech2_conformer_ljspeech.py:
    the transformer flagship's widths and training defaults with both
    stacks conformer, with overrides."""
    return train_hparams(**dict(overrides, **PATHS["conformer"][0]))


def trainer(kind: str) -> dict:
    """A flagship's training: its hparams, state, step and batch makers,
    the overrides that zero its dropouts, the name of its decoder's
    kernel-path attention, the ids of the kernels that carry it in fp32
    (forward at rate 0, forward with dropout, dq, dk/dv: the card-vs-CPU
    step's), in bf16 with no dropout where they differ (``bf16_kernels``,
    the Hopper design's forward and fused backward), and in the bf16
    train step (``step_kernels``: each launches once per decoder layer),
    and the (module, name) of the kernel path's
    forward and backward entries, whose calls the timed step captures."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    from transformer_tts_tpu_torch.train import trainer as tr
    fs2_no_dropout = dict(dropout=0.0, dropout_postnet=0.0,
                          dropout_variance_adaptor=0.0)
    calls = dict(fwd_call=(attention, "flash_attention"),
                 bwd_call=(fa, "flash_attention_bwd"))
    if kind == "fastspeech2":
        return dict(hparams=train_hparams, init=tr.init_fastspeech2_state,
                    make_step=tr.make_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K1", "K1-d", "K2-dq", "K2-dkdv"),
                    bf16_kernels=("K1-90", "K2-90"),
                    step_kernels=("K1-d-90", "K2-90"), **calls)
    if kind == "conformer":
        return dict(hparams=conformer_hparams,
                    init=tr.init_fastspeech2_state,
                    make_step=tr.make_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K4", "K4-d", "K5-dq", "K5-dkdv"),
                    bf16_kernels=("K4-90", "K5-90"),
                    step_kernels=("K4-d-90", "K5-90"),
                    fwd_call=(attention, "flash_relpos_attention"),
                    bwd_call=(fr, "flash_relpos_attention_bwd"))
    return dict(hparams=ar_hparams, init=tr.init_transformer_state,
                make_step=tr.make_transformer_train_step,
                batch=ar_train_batch, attn="attn_1",
                no_dropout=dict(dropout=0.0, dropout_prenet=0.0,
                                dropout_postnet=0.0),
                kernels=("K3-f", "K3-d", "K3-dq", "K3-dkdv"),
                bf16_kernels=("K3-f-90", "K3-90"),
                step_kernels=("K3-d-90", "K3-90"), **calls)


ADAM_EPS = 1e-9
# gradients, card fp32 against CPU fp32, each within this share of its own
# max|g|: sums run in other orders, and a ReLU whose input lies within
# rounding of 0 takes the other branch on one side, which moves its
# layer's weight gradient by up to ~1/sqrt(B*T) of max|g| (B*T = 1536
# here). The decoder attention weights, fed by K2 directly, hold tighter.
GRAD_TOL, ATTN_GRAD_TOL = 2e-2, 5e-3


def zero_in_exact_arithmetic(name: str) -> bool:
    """Gradients that cancel to 0, leaving rounding noise: a key bias (it
    adds one constant to each softmax row) and the conv biases before a
    BatchNorm (its batch mean takes them out): the postnet's and, in the
    conformer, each conv module's depthwise conv and the 1x1 conv after
    it."""
    return name.endswith("k_linear.bias") or (
        name.startswith("postnet.") and name.endswith(".bias")
        and (".conv1." in name or ".conv_list." in name)) or (
        ".conv_module.depth_conv1." in name and name.endswith(".bias"))


def decoder_attention(hp, attn: str) -> tuple:
    """Names of the decoder kernel-path attention's weights, whose
    gradients come through K2 (FastSpeech 2), K3 (the AR model) or K5 (the
    conformer, whose relative attention adds linear_pos and the two
    position biases)."""
    members = ["q_linear.weight", "k_linear.weight", "v_linear.weight",
               "out.weight"]
    if hp.decoder_type.lower() == "conformer":
        members += ["linear_pos.weight", "pos_bias_u", "pos_bias_v"]
    return tuple(f"decoder.layers.{i}.{attn}.{m}"
                 for i in range(hp.n_layer_decoder) for m in members)


# a ReLU input within this share of its call's max|x| lies within rounding
# of 0, where card and CPU may take either branch: the one such tie read
# out of an AR step had |x| = 1.5e-7 against max|x| = 7.27 (2.1e-8)
RELU_TIE = 1e-7
# at most this many ReLU inputs of one train step may take the card's
# branch on the CPU
RELU_FLIPS = 8


@contextmanager
def relu_branches(record=None, follow=None):
    """Within the block, ``torch.relu`` (every ReLU of the models) either
    appends each call's branch, x > 0 on the CPU, to the list ``record``,
    or, given ``follow`` (the branches another run recorded, call by
    call), takes that run's branch where its own input lies within
    RELU_TIE of 0 and the two differ. At such a tie both branches are
    right; a different one moves the layer's weight gradient by up to
    ~1/sqrt(B*T) of its max|g| (one flipped encoder unit in B*T = 256
    text positions: 3.3 %), which is not a disagreement of the two
    devices' arithmetic. Yields [the count of branches taken from
    ``follow``, the largest |x| / max|x| among them]."""
    real = torch.relu
    calls = iter(follow or ())
    forced = [0, 0.0]

    def relu(x):
        if record is not None:
            record.append((x > 0).cpu())
            return real(x)
        other = next(calls).to(x.device)
        check(other.shape == x.shape, "the ReLU calls of the two runs differ")
        top = x.abs().amax()
        take = (x.abs() <= RELU_TIE * top) & (other != (x > 0))
        if bool(take.any()):
            forced[0] += int(take.sum())
            forced[1] = max(forced[1], float(x.abs()[take].max() / top))
        return torch.where(take, x * other, real(x))

    if record is None and follow is None:
        yield forced
        return
    torch.relu = relu
    try:
        yield forced
    finally:
        torch.relu = real


def ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def phase_card_vs_cpu(gen, kind):
    """One train step on the card and on the CPU from the same weights:
    the flagship in fp32 with every dropout 0, where the decoder takes K1
    and K2 (FastSpeech 2), K4 and K5 (the conformer) or K3 and its
    backward (the AR model, 383 decoder groups) on the simple design; then
    the same step with bf16 amp on the card, which every flagship must
    take on the Hopper design alone (K1-90 and K2-90, K4-90 and K5-90,
    K3-f-90 and K3-90). Every decoder attention weight's card gradient
    must be non-zero.
    warmup_step 10 makes Adam's first update lr * g / (|g| + 1e-9) ~
    lr * sign(g) with lr = 1.6e-3, far above fp32's rounding of the
    weights, so the updates show every gradient's sign, however small the
    gradient. The CPU's step follows the card's fp32 step at ReLU inputs
    within rounding of 0 (``relu_branches``)."""
    spec = trainer(kind)
    b, text_len, mel_len, frames = CPU_STEP_BATCH
    fp32 = dict(spec["no_dropout"], amp=False, warmup_step=10)
    hp32 = spec["hparams"](**fp32)
    batch = spec["batch"](gen, hp32, b, text_len, mel_len, frames, "cpu")
    ref = spec["init"](hp32, device="cpu")
    weights = {k: v.clone() for k, v in ref.model.state_dict().items()}
    counts = read_counts()
    results, launched, branches = {}, {}, []
    for amp in (False, True):
        hp = spec["hparams"](**dict(fp32, amp=amp))
        state = spec["init"](hp, device=DEVICE)
        state.model.load_state_dict(weights)
        before = read_counts()
        with relu_branches(record=None if amp else branches):
            state, logs = spec["make_step"](hp, device=DEVICE)(state, batch)
        torch.cuda.synchronize()
        launched[amp] = {k: n - before[k] for k, n in read_counts().items()}
        results[amp] = (state, logs)
    with relu_branches(follow=branches) as forced:
        ref, ref_logs = spec["make_step"](hp32, device="cpu")(ref, batch)
    lr = ref.optimizer.schedule(0)
    check(forced[0] <= RELU_FLIPS,
          f"{kind}: {forced[0]} ReLU inputs within rounding of 0 took "
          f"another branch on the CPU than on the card (at most "
          f"{RELU_FLIPS})")
    fwd, _, dq, dkdv = spec["kernels"]
    check(all(launched[False][k] > 0 for k in (fwd, dq, dkdv)),
          f"{kind}: the card's fp32 step did not take {fwd}, {dq} and "
          f"{dkdv}: {launched[False]}")
    if spec["bf16_kernels"]:      # bf16, no dropout: the Hopper design
        h_fwd, h_bwd = spec["bf16_kernels"]
        check(launched[True][h_fwd] > 0 and launched[True][h_bwd] > 0
              and not any(launched[True][k] for k in (fwd, dq, dkdv)),
              f"{kind}: the card's bf16 step did not take {h_fwd} and "
              f"{h_bwd} alone: {launched[True]}")
    set_counts(counts)

    state, logs = results[False]
    loss, ref_loss = float(logs["loss_total"]), float(ref_logs["loss_total"])
    # fp32 on both sides (TF32 off): sums in other orders through 12 layers
    check(abs(loss - ref_loss) <= 1e-4 * abs(ref_loss),
          f"card fp32 loss {loss} vs CPU {ref_loss}")
    cpu_params = dict(ref.model.named_parameters())
    # the .grad the optimizer left: clipped in place, on both sides alike
    top = max(p.grad.abs().max().item() for p in cpu_params.values())
    grad_rel, update_rel, settled_share, noise_peak = {}, {}, {}, 0.0
    for name, p in state.model.named_parameters():
        g, g_ref = p.grad.cpu(), cpu_params[name].grad
        old = weights[name]
        step = p.detach().cpu() - old
        ref_step = cpu_params[name].detach() - old
        rounding = 2 * ulp(old.abs() + lr)
        check(bool((step.abs() <= lr * (1 + 1e-4) + rounding).all()),
              f"{name}: an update larger than lr")
        err, peak = max_err(g, g_ref)
        if zero_in_exact_arithmetic(name):
            # noise on both sides, which Adam's first step turns into any
            # update in [-lr, lr]
            noise_peak = max(noise_peak, peak, g.abs().max().item())
            continue
        grad_rel[name] = err / peak if peak > 0 else float(err > 0)
        # Adam's first update is lr * f(g), f(x) = x / (|x| + eps), whose
        # slope eps / (|x| + eps)^2 is largest where |x| is least; between
        # two gradients within err of each other |x| >= m = max(|g| - err,
        # 0), so their updates lie within lr * err * eps / (m + eps)^2.
        # Where that bound is <= 1e-3 lr (a gradient far above err, or err
        # far below eps), the updates must agree to 1e-3 lr.
        least = (g_ref.abs() - err).clamp(min=0.0)
        settled = err * ADAM_EPS / (least + ADAM_EPS) ** 2 <= 1e-3
        settled_share[name] = settled.float().mean().item()
        update_rel[name] = ((step - ref_step).abs() - rounding)[
            settled].max().item() / lr if settled.any() else 0.0
    stats_rel = 0.0
    cpu_buffers = dict(ref.model.named_buffers())
    for name, v in state.model.named_buffers():
        if "running" in name:
            err, peak = max_err(v.cpu(), cpu_buffers[name])
            stats_rel = max(stats_rel, err / max(peak, 1e-30))
    attn = decoder_attention(hp, spec["attn"])
    worst = sorted(grad_rel, key=grad_rel.get)[-3:]
    attn_worst = max(attn, key=grad_rel.get)
    attn_peaks = [cpu_params[n].grad.abs().max().item() for n in attn]
    card_params = dict(state.model.named_parameters())
    dead = [n for n in attn if not bool((card_params[n].grad != 0).any())]
    check(not dead, f"{kind}: decoder attention weights with no card "
                    f"gradient: {dead}")
    attn_share = min(settled_share[n] for n in attn)
    print(f"{kind} train step B={b} L={text_len} T={mel_len} card fp32 vs "
          f"CPU fp32:"
          f" loss {loss:.6f} vs {ref_loss:.6f}; gradients, each against its "
          f"own max|g| (tol {GRAD_TOL}): worst "
          + ", ".join(f"{n} {grad_rel[n]:.3g}" for n in worst)
          + f"; of the decoder attention weights (tol {ATTN_GRAD_TOL}) "
          f"{attn_worst} {grad_rel[attn_worst]:.3g}, their max|g| "
          f"{min(attn_peaks):.3g}"
          f"..{max(attn_peaks):.3g} (largest gradient {top:.3g}); "
          f"key and pre-BatchNorm conv biases, zero but for rounding, "
          f"at most {noise_peak:.3g} (tol {1e-5 * top:.3g}); "
          f"updates at lr {lr:.4g}: worst |d update| / lr "
          f"{max(update_rel.values()):.3g} (tol 1e-3) where the gradients "
          f"bound it below 1e-3, at least {attn_share:.1%} of each decoder "
          f"attention "
          f"weight; BatchNorm statistics {stats_rel:.3g} of their own "
          f"max|ref| (tol 1e-3); ReLU inputs within {RELU_TIE:g} of their "
          f"call's max|x| where the CPU took the card's branch: {forced[0]} "
          f"(at most {RELU_FLIPS}) of {sum(x.numel() for x in branches)}, "
          f"the largest at {forced[1]:.3g} of max|x|; card launches "
          f"{json.dumps(launched)}")
    check(max(grad_rel.values()) <= GRAD_TOL
          and grad_rel[attn_worst] <= ATTN_GRAD_TOL
          and noise_peak <= 1e-5 * top,
          f"{kind}: card gradients disagree with the CPU's: worst {worst}")
    check(max(update_rel.values()) <= 1e-3 and attn_share >= 0.5,
          f"{kind}: card updates disagree with the CPU's")
    check(stats_rel <= 1e-3, f"{kind}: card BatchNorm statistics disagree")

    state, logs = results[True]
    loss, norm = float(logs["loss_total"]), float(logs["grad_norm"])
    ref_norm = float(ref_logs["grad_norm"])
    norms = {n: (dict(state.model.named_parameters())[n].grad.float()
                 .norm().item(), cpu_params[n].grad.norm().item())
             for n in attn}
    norm_rel = max(abs(x - y) / y for x, y in norms.values())
    print(f"{kind} train step card bf16 amp vs CPU fp32: loss {loss:.6f} vs "
          f"{ref_loss:.6f} (tol 2e-2 relative), grad_norm {norm:.6f} vs "
          f"{ref_norm:.6f} (tol 5 %), the decoder attention weights' "
          f"gradient norms within {norm_rel:.3g} (tol 5 %)")
    # bf16 keeps ~3 significant digits through 12 layers and the postnet
    check(abs(loss - ref_loss) <= 2e-2 * abs(ref_loss)
          and abs(norm - ref_norm) <= 0.05 * ref_norm
          and norm_rel <= 0.05,
          f"{kind}: card bf16 amp step disagrees with the CPU's")


def phase_train_step(batch, kind):
    """The main path of a flagship's training at full width, bf16 amp,
    dropout 0.1, on a fixed batch (TRAIN_BATCH); 3 warm-up steps, then 10
    timed ones with every launch count set to 0 just before; then 20
    steps with warmup_step 100 whose loss must fall. Returns the timed
    run's launch counts and the kernel path's forward and backward inputs
    of the first decoder layer in the last warm-up step."""
    spec = trainer(kind)
    b, text_len, mel_len, _ = TRAIN_BATCH
    hp = spec["hparams"]()
    state = spec["init"](hp, device=DEVICE)
    step = spec["make_step"](hp, device=DEVICE)
    fwd_calls, bwd_calls = [], []
    for i in range(3):
        if i == 2:      # the last warm-up step's kernel inputs
            with capture_calls(*spec["fwd_call"], fwd_calls), \
                    capture_calls(*spec["bwd_call"], bwd_calls):
                state, logs = step(state, batch)
        else:
            state, logs = step(state, batch)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    set_counts({})                          # the main path starts here
    per_step, times, losses = [], [], []
    for _ in range(10):
        before = read_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, logs = step(state, batch)
        end.record()
        losses.append(logs["loss_total"])
        per_step.append({k: n - before[k] for k, n in read_counts().items()})
        times.append((start, end))
    torch.cuda.synchronize()
    launches = read_counts()                # it ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(s.elapsed_time(e) for s, e in times)
    losses = torch.stack(losses).float().cpu()
    frames_valid = int((batch["pos_mel"] > 0).sum())
    print(f"{kind} train step B={b} L={text_len} T={mel_len} bf16 amp "
          f"dropout 0.1: {ms:.3f} ms/step (median of 10), {frames_valid} "
          f"valid mel frames = {frames_valid / ms * 1e3:.0f} frames/s "
          f"({b * mel_len / ms * 1e3:.0f} bucket frames/s), peak memory "
          f"{peak_gb:.2f} GB; losses {[round(x, 4) for x in losses.tolist()]}")
    want = {k: 0 for k in counters()}
    want.update({k: hp.n_layer_decoder for k in spec["step_kernels"]})
    print(f"{kind} train main path: launches per step "
          f"{json.dumps(per_step[0])} (expect {json.dumps(want)}), total "
          f"{json.dumps(launches)}")
    check(all(c == want for c in per_step),
          f"{kind} train step launches {per_step} differ from {want}")
    check(bool(torch.isfinite(losses).all()), f"{kind}: non-finite loss")
    check(len(fwd_calls) == hp.n_layer_decoder
          and len(bwd_calls) == hp.n_layer_decoder,
          f"{kind}: kernel path calls per step")
    fwd_inputs = fwd_calls[0]         # the first decoder layer's forward
    bwd_inputs = bwd_calls[-1]        # and its backward, which runs last
    PROFILES.append(partial(profile_train_step, kind, batch, ms))
    del state, step
    torch.cuda.empty_cache()

    hp = spec["hparams"](warmup_step=100)
    state = spec["init"](hp, device=DEVICE)
    step = spec["make_step"](hp, device=DEVICE)
    curve = []
    for _ in range(20):
        state, logs = step(state, batch)
        curve.append(logs["loss_total"])
    curve = torch.stack(curve).float().cpu().tolist()
    print(f"{kind}: 20 steps on one batch, warmup_step 100: loss "
          f"{curve[0]:.4f} -> {curve[-1]:.4f} "
          f"({[round(x, 3) for x in curve]})")
    check(all(math.isfinite(x) for x in curve) and curve[-1] < curve[0],
          f"{kind}: the loss did not fall over 20 steps")
    del state, step
    torch.cuda.empty_cache()
    return launches, fwd_inputs, bwd_inputs


def profile_train_step(kind, batch, ms_per_step):
    """``print_profile`` of 3 train steps of ``kind`` on ``batch``, from a
    fresh state after 3 warm-up steps."""
    spec = trainer(kind)
    hp = spec["hparams"]()
    state = spec["init"](hp, device=DEVICE)
    step = spec["make_step"](hp, device=DEVICE)
    for _ in range(3):
        state, _ = step(state, batch)
    print_profile(f"the {kind} train step", partial(step, state, batch), 3,
                  ms_per_step)


def write_train_corpus(gen, hp, root):
    """A synthetic corpus at flagship width: mels with alignment, f0 and
    energy siblings, and a script file."""
    n_utts, (lo, hi), _ = CLI_CORPUS
    os.makedirs(root, exist_ok=True)
    lines = []
    for i in range(n_utts):
        frames = int(torch.randint(lo, hi + 1, (), generator=gen))
        n_text = max(1, frames // 6)
        dur = torch.full((n_text,), frames // n_text, dtype=torch.int32)
        dur[: frames - int(dur.sum())] += 1
        base = os.path.join(root, f"utt{i}.npy")
        np.save(base, torch.randn(frames, hp.mel_dim,
                                  generator=gen).numpy())
        np.save(base.replace(".npy", "_alignment.npy"), dur.numpy())
        np.save(base.replace(".npy", "_f0.npy"),
                (torch.rand(frames, generator=gen) * 740 + 60).numpy())
        np.save(base.replace(".npy", "_energy.npy"),
                (torch.rand(frames, generator=gen) * 315).numpy())
        ids = torch.randint(1, hp.vocab_size, (n_text,), generator=gen)
        lines.append(f"{base}|{' '.join(map(str, ids.tolist()))}")
    script = os.path.join(root, "train.txt")
    with open(script, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return script


def phase_train_cli(gen, kind):
    """cli/train.py for 3 steps on a synthetic corpus, then cli/synthesize.py
    on the checkpoint it saved."""
    hp = trainer(kind)["hparams"]()
    work = os.path.join(WORK, f"train_{kind}")
    script = write_train_corpus(gen, hp, os.path.join(work, "corpus"))
    save_dir = os.path.join(work, "checkpoints")
    hp_file = os.path.join(work, "hparams.py")
    with open(hp_file, "w") as fh:
        for key, value in dict(FLAGSHIP, model=hp.model,
                               encoder_type=hp.encoder_type,
                               decoder_type=hp.decoder_type,
                               train_script=script, save_dir=save_dir,
                               batch_size=CLI_CORPUS[2], max_epoch=1,
                               save_per_epoch=1).items():
            fh.write(f"{key} = {value!r}\n")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.train",
         "--hp_file", hp_file, "--max_steps", "3", "--device", DEVICE],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    steps = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("epoch 1 step")]
    print("\n".join(steps))
    check(proc.returncode == 0, f"{kind} train CLI exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(len(steps) == 3, f"{kind} train CLI did not log 3 steps")
    load_dir = os.path.join(save_dir, "epoch_1")
    check(os.path.exists(os.path.join(load_dir, "model.pt"))
          and os.path.exists(os.path.join(load_dir, "hparams.py")),
          f"{kind} train CLI saved no checkpoint")
    test_script = os.path.join(work, "test.txt")
    with open(script) as src, open(test_script, "w") as dst:
        dst.write("".join(src.readlines()[:3]))
    out_dir = os.path.join(work, "generated")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.synthesize",
         "--load_name", load_dir, "--test_script", test_script, "--save",
         out_dir, "--max_frames", "2048", "--device", DEVICE], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"{kind} synthesis CLI on the trained "
          f"checkpoint exit {proc.returncode}: {proc.stderr[-2000:]}")
    frames = []
    for i in range(3):
        mel = np.load(os.path.join(out_dir, f"{i}.npy"))
        frames.append(mel.shape[0])
        check(mel.ndim == 2 and mel.shape[1] == hp.mel_dim
              and mel.shape[0] > 0 and bool(np.isfinite(mel).all()),
              f"{kind} synthesis from the trained checkpoint: mel {i} "
              f"{mel.shape}")
    print(f"{kind} train CLI: 3 steps, checkpoint "
          f"{os.path.relpath(load_dir, ROOT)}; synthesis CLI read it and "
          f"wrote 3 mels of {frames} frames")


# ---- phase 6: the AR Transformer-TTS ----------------------------------------

AR_TF = (2, 128, 300)           # B, text bucket, decoder groups (>= 256)
AR_DECODE_STEPS = 300
AR_SYNTH_BATCHES = (1, 8)
AR_STOP_BIAS = -30.0            # no row stops: every call decodes 500 groups


def ar_model(device, amp: bool, seed: int = 0):
    from transformer_tts_tpu_torch.models.transformer_tts import (
        build_transformer_tts)
    hp = ar_hparams(amp=amp)
    return hp, build_transformer_tts(hp, device=device, seed=seed).eval()


def group_positions(lengths, t: int):
    pos = torch.arange(1, t + 1)[None]
    return torch.where(pos <= torch.as_tensor(lengths)[:, None], pos, 0)


def phase_ar_teacher_forced(gen):
    """The AR flagship's teacher-forced forward in eval mode over
    AR_TF's 300 decoder groups, whose masked self-attention takes K3 at
    rate 0: card fp32 against the CPU's fp32 at 1e-3 of max(1, max|ref|)
    on mel_post and the stop logits, card bf16 amp at 5e-2 of it; each
    forward a path of its own, counted from 0 (6 launches of the simple
    K3-f in fp32, of the Hopper design's K3-f-90 in bf16, nothing else).
    Returns the bf16 forward's launches and its first decoder layer's
    kernel input, the input K3-f-90 and K3-f are timed at."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops.masks import create_masks
    b, text_len, t = AR_TF
    hp, cpu_model = ar_model("cpu", amp=False)
    text, pos_text = text_batch(gen, b, text_len, 100, hp.vocab_size)
    trg = torch.randn(b, t, hp.mel_dim, generator=gen)
    pos_mel = group_positions([t, t - 60], t)
    masks = create_masks(pos_text, pos_mel, model="transformer")
    inputs = (text.long(), trg, *masks)
    with torch.no_grad():
        ref = cpu_model(*inputs)
    del cpu_model
    _, model = ar_model(DEVICE, amp=False)
    cuda_inputs = [x.to(DEVICE) for x in inputs]
    captured = []
    for amp in (False, True):
        model.amp = amp
        set_counts({})                      # this path starts here
        with torch.no_grad(), capture_calls(attention, "flash_attention",
                                            captured if amp else []):
            out = model(*cuda_inputs)
        torch.cuda.synchronize()
        launched = read_counts()            # and ends here
        want = {k: 0 for k in counters()}
        want["K3-f-90" if amp else "K3-f"] = hp.n_layer_decoder
        check(launched == want, f"AR eval forward launches {launched}, "
                                f"expected {want}")
        errs = {}
        for name in ("mel_post", "stop_token"):
            want_t = getattr(ref, name)
            errs[name] = max_err(getattr(out, name).cpu(), want_t)
        peak = max(p for _, p in errs.values())
        tol = (5e-2 if amp else 1e-3) * max(1.0, peak)
        label = "bf16 amp" if amp else "fp32"
        print(f"AR teacher-forced forward B={b} L={text_len} T_dec={t}: "
              f"card {label} vs CPU fp32: max|d mel_post| = "
              f"{errs['mel_post'][0]:.3g}, max|d stop| = "
              f"{errs['stop_token'][0]:.3g} (tol {tol:.3g}, max|ref| "
              f"{peak:.3g}); launches {json.dumps(launched)}")
        check(all(e <= tol for e, _ in errs.values()),
              f"AR: card {label} forward disagrees with the CPU")
    set_counts({})
    return launched, captured[0]


def phase_ar_decode_vs_forward(gen):
    """The KV-cached decode loop of synthesize_transformer_tts (fp32, no
    stop) for AR_DECODE_STEPS steps, counted from 0: no kernel launches;
    then the teacher-forced forward of the frames the loop fed itself,
    on the card (its self-attention on K3-f): each step's group must
    equal the forward's row within 1e-3 of max(1, max|ref|)."""
    from transformer_tts_tpu_torch.infer.synthesize import _ar_body, _ar_init
    from transformer_tts_tpu_torch.ops.masks import create_masks, pad_mask
    b, text_len, _ = AR_TF
    steps = AR_DECODE_STEPS
    hp, model = ar_model(DEVICE, amp=False)
    text, pos_text = (x.to(DEVICE) for x in text_batch(
        gen, b, text_len, 100, hp.vocab_size))
    text = text.long()
    src_mask = pad_mask(pos_text)
    set_counts({})                          # the decode starts here
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        carry = _ar_init(model, b, steps, DEVICE)
        body = _ar_body(model, e_outputs, src_mask, cross, 2.0)
        fed = []
        for _ in range(steps):
            fed.append(carry["prev"].clone())   # the step writes in place
            body(carry)
    torch.cuda.synchronize()
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"the AR decode launched a kernel: {launched}")
    trg = torch.cat(fed, 1)
    pos_mel = group_positions([steps] * b, steps).to(DEVICE)
    with torch.no_grad():
        out = model(text, trg, *create_masks(pos_text, pos_mel,
                                             model="transformer"))
    set_counts({})
    err, peak = max_err(carry["groups"], out.mel_pre)
    tol = 1e-3 * max(1.0, peak)
    print(f"AR KV-cached decode, {steps} steps B={b} fp32: launches "
          f"{json.dumps(launched)}; every group against the teacher-forced "
          f"forward of the fed-back frames: max|d| = {err:.3g} (tol "
          f"{tol:.3g}, max|ref| {peak:.3g})")
    check(err <= tol, "the AR decode disagrees with the teacher-forced "
                      "forward")


def ar_call_ms(call, reps: int) -> tuple:
    """(median ms of ``reps`` calls, the first call's output); each call
    ends in a synchronize. The model and the graph are warm by then."""
    walls, first = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        first = out if first is None else first
    return statistics.median(walls), first


@contextmanager
def stop_logits(model, store: list):
    """While the block runs, append to ``store`` (once it ends) the
    (steps, B, r) stop logits, without the stop head's bias, of the eager
    decode steps it runs: the head's input times its weight, both in the
    dtype the head computes in, in float64. A row's stop changes nothing
    the loop feeds back, so the trajectory holds for any bias. (The hooks
    fire in the eager loop only; a graph replays no Python.)"""
    seen = []
    hook = model.stop_token.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[0][:, 0]))
    try:
        yield
    finally:
        hook.remove()
    dtype = model.cache_dtype           # what the head computes in
    x = torch.stack(seen).to(dtype).double()             # (steps, B, d)
    w = model.stop_token.weight.detach().to(dtype).double()
    store.append(torch.einsum("sbd,rd->sbr", x, w).cpu().numpy())


def stopping_bias(logits: np.ndarray, max_steps: int) -> float:
    """A stop-head bias at which every row stops before ``max_steps``, at
    as many different steps as the candidates offer, preferring none in
    the first block: a row stops at its first step whose mean stop
    probability, sigmoid(logit + bias) over the r frames, is above 0.5.
    The candidates lie midway between the levels at which a step's mean
    logit crosses 0, so rounding does not move a stop."""
    levels = np.unique(-logits.mean(-1))
    mids = (levels[1:] + levels[:-1]) / 2
    mids = mids[np.linspace(0, len(mids) - 1, min(len(mids), 1000))
                .round().astype(int)]
    best, best_key = None, None
    for beta in mids:
        p = (1.0 / (1.0 + np.exp(-(logits + beta)))).mean(-1)  # (steps, B)
        over = p > 0.5
        if not over.any(0).all():
            continue
        first = over.argmax(0) + 1
        key = (len(set(first.tolist())), first.min() > 8)
        if best_key is None or key > best_key:
            best, best_key = float(beta), key
    check(best is not None, "no stop bias makes every row stop")
    return best


def weight_casts(model, run) -> int:
    """Casts (``aten.to``, ``aten._to_copy``) of the model's parameters to
    another dtype while ``run()`` runs, seen by a TorchDispatchMode:
    autocast's casts of the weights."""
    from torch.utils._python_dispatch import TorchDispatchMode
    params = {p.data_ptr(): p.dtype for p in model.parameters()}
    casts = (torch.ops.aten.to, torch.ops.aten._to_copy)

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func.overloadpacket in casts
                    and args[0].data_ptr() in params
                    and out.dtype != params[args[0].data_ptr()]):
                self.n += 1
            return out

    with Count() as count:
        run()
    return count.n


def phase_ar_decode_weight_casts(model, text, pos):
    """One eager decode step on the card: the weight casts autocast makes
    with the fp32 parameters, and with the graph's bf16 copies
    (``DecodeWeights``) swapped in, as the graph captures the step: none."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    src_mask = pad_mask(pos)
    with torch.inference_mode():
        e_outputs, _ = model.encode(text, src_mask)
        cross = model.precompute_cross_kv(e_outputs)
        weights = synth.DecodeWeights(model)

        def step():
            synth.ar_decode(model, e_outputs, src_mask, cross, 1, 0.5)
        plain = weight_casts(model, step)
        with weights.swapped_in():
            swapped = weight_casts(model, step)
    print(f"AR decode step B={text.shape[0]}: {plain} weight casts with the "
          f"fp32 parameters, {swapped} with the {len(weights.slots)} bf16 "
          f"copies the graph reads")
    check(plain > 0 and swapped == 0,
          f"AR decode step: {swapped} weight casts with the bf16 copies in")


def phase_ar_synthesis(gen):
    """synthesize_transformer_tts at the flagship's width, bf16 amp,
    max_steps 500, B=1 and B=8: the main path replays the decode's CUDA
    graph, its launches counted from 0 (none). The stop head's bias at
    AR_STOP_BIAS makes every row decode all 500 groups (the longest call);
    a second bias, chosen from both eager runs' stop logits, makes every
    row stop early, B=8's rows at different steps. At both biases and both batch sizes the
    graph's mel and lengths must equal the eager loop's bit for bit. Times
    at AR_STOP_BIAS, the graph's the median of 3 calls, the eager loop's
    of one (~10 ms a step): ms per call and per decode step, RTF; then
    one graphed B=8 call under the profiler."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        MAX_AR_STEPS, synthesize_transformer_tts)
    hp, model = ar_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    batches = []
    for batch in AR_SYNTH_BATCHES:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.long().to(DEVICE), pos.to(DEVICE)))
    frames = MAX_AR_STEPS * hp.reduction_rate
    set_counts({})                          # the path starts here
    for text, pos in batches:
        t0 = time.perf_counter()
        mel, lengths = synthesize_transformer_tts(model, text, pos)
        torch.cuda.synchronize()
        print(f"AR synthesis B={text.shape[0]}: first graphed call (warm-up "
              f"and capture) {(time.perf_counter() - t0) * 1e3:.1f} ms")
        check(mel.shape == (text.shape[0], frames, hp.mel_dim)
              and bool(torch.isfinite(mel).all())
              and bool((lengths == frames).all()),
              f"AR synthesis: mel {tuple(mel.shape)}, lengths "
              f"{lengths.tolist()}")
    launched = read_counts()                # and ends here
    check(not any(launched.values()),
          f"AR synthesis launched a kernel: {launched}")

    results, logits = {}, []
    for text, pos in batches:
        b = text.shape[0]
        results[b, "graph"] = ar_call_ms(
            lambda: synthesize_transformer_tts(model, text, pos), 3)
        with stop_logits(model, logits):
            results[b, "eager"] = ar_call_ms(
                lambda: synthesize_transformer_tts(model, text, pos,
                                                   eager=True), 1)
        (g_mel, g_len), (e_mel, e_len) = (results[b, n][1]
                                          for n in ("graph", "eager"))
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"AR B={b}: the graph's mel or lengths differ from the eager "
              f"loop's")
    stop_bias = stopping_bias(np.concatenate(logits, axis=1), MAX_AR_STEPS)
    with torch.no_grad():
        model.stop_token.bias.fill_(stop_bias)
    for text, pos in batches:
        g_mel, g_len = synthesize_transformer_tts(model, text, pos)
        e_mel, e_len = synthesize_transformer_tts(model, text, pos,
                                                  eager=True)
        print(f"AR B={text.shape[0]} stop bias {stop_bias:.4f}: lengths "
              f"graph {g_len.tolist()}, eager {e_len.tolist()}")
        check(torch.equal(g_mel, e_mel) and torch.equal(g_len, e_len),
              f"AR B={text.shape[0]} with stops: the graph differs from "
              f"the eager loop")
        check(int(g_len.max()) < frames
              and (text.shape[0] == 1 or len(set(g_len.tolist())) > 1),
              f"AR: the stop bias did not stop the rows early at different "
              f"steps: {g_len.tolist()}")
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    for text, pos in batches:
        phase_ar_decode_weight_casts(model, text, pos)

    for (b, name), (ms, (_, lengths)) in sorted(results.items()):
        audio_s = lengths.sum().item() * HOP_SECONDS
        print(f"AR synthesize_transformer_tts B={b} L=128 max_steps "
              f"{MAX_AR_STEPS} bf16 amp, {name}: {ms:.3f} ms/call "
              f"({'median of 3' if name == 'graph' else 'one call'}), "
              f"{ms / MAX_AR_STEPS:.4f} ms per decode step, "
              f"{lengths.sum().item()} frames = {audio_s:.3f} s audio, RTF "
              f"{ms / 1e3 / audio_s:.6f}")
    for text, pos in batches:
        PROFILES.append(partial(profile_ar_synthesis, (text, pos),
                                results[text.shape[0], "graph"][0]))
    del model
    torch.cuda.empty_cache()


def profile_ar_synthesis(batch, ms_per_call):
    """``print_profile`` of one graphed ``synthesize_transformer_tts`` call
    on ``batch`` (text, positions) at AR_STOP_BIAS, after the call that
    captures its graphs; then the device operations per decode step (all
    of the call's over its MAX_AR_STEPS steps; the encoder and postnet add
    a few dozen), the copy kernels among them, and the bf16 weight copies
    the graph reads in place of as many per-step casts."""
    from transformer_tts_tpu_torch.infer import synthesize as synth
    _, model = ar_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    call = partial(synth.synthesize_transformer_tts, model, *batch)
    call()
    b = batch[0].shape[0]
    ops = print_profile(f"AR graphed synthesis B={b}, one call", call, 1,
                        ms_per_call)
    steps = synth.MAX_AR_STEPS
    per_step = sum(e.count for e in ops) / steps
    copies = sum(e.count for e in ops if "copy" in e.key.lower()) / steps
    slots = sum(len(g.weights.slots)
                for g in synth._AR_GRAPHS[model].values())
    print(f"AR graphed synthesis B={b}: {per_step:.1f} device operations "
          f"per decode step, {copies:.1f} of them copy kernels; the graph "
          f"reads {slots} bf16 weight copies (DecodeWeights) instead of "
          f"casting them at every step")


# ---- phase 7: the kernels at their main paths' inputs -----------------------

def attended_pairs(t_q: int, k_len, causal: bool) -> float:
    """The (query row, key) pairs the attention computes for these
    inputs: T_q * sum_b k_len[b], or with ``causal`` sum_b sum_{r<T_q}
    min(r + 1, k_len[b]) -- about half."""
    kl = k_len.double()
    if not causal:
        return t_q * kl.sum().item()
    rows = torch.arange(1, t_q + 1, dtype=torch.float64, device=kl.device)
    return torch.minimum(rows[None, :], kl[:, None]).sum().item()


def sdpa_mask(t_q: int, t_k: int, k_len, causal: bool):
    """The boolean mask of the SDPA yardstick: keys < k_len[b], and with
    ``causal`` keys <= the row (the decoder's pad-and-causal mask)."""
    cols = torch.arange(t_k, device=k_len.device)
    mask = (cols[None, :] < k_len[:, None])[:, None, None, :]
    if causal:
        rows = torch.arange(t_q, device=k_len.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None, None]
    return mask


def train_kernel_timings(fwd_inputs, bwd_inputs, causal=False) -> dict:
    """The training kernels at the train step's captured input -- the
    FastSpeech 2 step's K1-d-90 and K2-90 (the Hopper design it runs) or,
    with ``causal``, the AR step's K3-d-90 and K3-90 and, in the same run,
    the simple design's forward and dq and dk/dv pair on the same input
    (K1-d, K2-dq, K2-dkdv; K3-d, K3-dq, K3-dkdv: the A/B): kernel, plain
    and library ms, the bound, and each kernel against its fp32 plain
    version there (``check_train_kernels``: O, dq, dk and dv within 2e-2
    of their own max |ref| in bf16), with the O the step's forward gave
    equal bit for bit to a second launch on the same seed.
    The library calls are SDPA with the key mask (with ``causal`` the
    pad-and-causal mask) and the same dropout rate, forward and backward
    (the backward one gives dq, dk and dv together, the yardstick of every
    backward entry). The bounds count the (row, key) pairs these inputs
    attend (``attended_pairs``)."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    counts = read_counts()
    (q, k, v, k_len), fkw = fwd_inputs
    (bq, bk, bv, o, lse, do, bk_len), bkw = bwd_inputs
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    check(all(torch.equal(x, y) for x, y in ((q, bq), (k, bk), (v, bv),
                                            (k_len, bk_len)))
          and (bkw["dropout_rate"], bkw["dropout_seed"]) == (rate, seed)
          and fkw.get("causal", False) == causal
          and bkw.get("causal", False) == causal,
          "the captured backward is not the captured forward's")
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len.clamp(max=k.shape[2]), causal)
    pairs = attended_pairs(t_q, k_len.clamp(max=k.shape[2]), causal)
    el = q.element_size()
    klen_bytes = k_len.numel() * 4
    fwd_bound = bound_ms(4 * h * pairs * d,
                         (2 * q.numel() + k.numel() + v.numel()) * el
                         + b * h * t_q * 4 + klen_bytes, q.dtype)  # o, lse
    # read: q, k, v, dO, lse, delta, k_len; written: dq (bf16), dk, dv
    in_bytes = ((q.numel() + k.numel() + v.numel() + do.numel()) * el
                + 2 * b * h * t_q * 4 + klen_bytes)
    dkdv_bytes = (k.numel() + v.numel()) * el
    pair_bound = bound_ms(10 * h * pairs * d,
                          in_bytes + q.numel() * el + dkdv_bytes, q.dtype)
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
    bkw = dict(kw, causal=causal)
    res, fwd_ids = {}, []
    with torch.no_grad():
        library_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=rate, scale=sm_scale))
        plain_fwd = time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, k_len, sm_scale, rate, seed, causal))
        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, k_len)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_reference(
            *args, sm_scale, rate, seed, causal))
        plain_dkdv = time_ms(lambda: fa.flash_attention_dkdv_reference(
            *args, sm_scale, rate, seed, causal))
        for design in ("sm90", "simple"):
            errs, peaks, o_again = check_train_kernels(
                q, k, v, do, k_len, rate, seed, " (train step input)",
                causal=causal, design="simple" if design == "simple"
                else None)
            if design == "sm90":                # what the step itself ran
                check(torch.equal(o_again, o),
                      f"{design}: another O on the same input and seed than "
                      f"in the train step")
            fwd_id, ids = train_kernel_ids(design, causal, rate)
            fwd_ids.append(fwd_id)
            if design == "simple":
                fwd_call = partial(simple_flash_attention, q, k, v, k_len,
                                   causal=causal, **kw)
            else:
                fwd_call = partial(fa.flash_attention, q, k, v, k_len,
                                   dropout_rate=rate, dropout_seed=seed,
                                   causal=causal)
            res[fwd_id] = {
                "ms": time_ms(fwd_call), "plain_ms": plain_fwd,
                "library_ms": library_fwd, "max_abs_err": errs["o"],
                "max_abs_ref": peaks["o"]}
            res[fwd_id]["bound_ms"], res[fwd_id]["bound_by"] = fwd_bound
            print(f"{fwd_id}/{'/'.join(ids)} vs plain at the train step's "
                  f"input: " + " ".join(
                      f"max|d{n}|={e:.3g} (max|ref| {peaks[n]:.3g})"
                      for n, e in errs.items()))
            if design == "sm90":
                res[ids[0]] = {
                    "ms": time_ms(lambda: fa.flash_attention_bwd_sm90(
                        *args, **bkw)),
                    "plain_ms": plain_dq + plain_dkdv,
                    **worst_err(errs, peaks, ("dq", "dk", "dv"))}
                res[ids[0]]["bound_ms"], res[ids[0]]["bound_by"] = (
                    pair_bound)
                continue
            dq_id, dkdv_id = ids
            res[dq_id] = {
                "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args,
                                                                **bkw)),
                "plain_ms": plain_dq,
                "max_abs_err": errs["dq"], "max_abs_ref": peaks["dq"]}
            res[dq_id]["bound_ms"], res[dq_id]["bound_by"] = bound_ms(
                6 * h * pairs * d, in_bytes + q.numel() * el, q.dtype)
            res[dkdv_id] = {
                "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args,
                                                                  **bkw)),
                "plain_ms": plain_dkdv,
                **worst_err(errs, peaks, ("dk", "dv"))}
            res[dkdv_id]["bound_ms"], res[dkdv_id]["bound_by"] = bound_ms(
                8 * h * pairs * d, in_bytes + dkdv_bytes, q.dtype)
        rate0 = time_ms(lambda: fa.flash_attention(q, k, v, k_len,
                                                   causal=causal))
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    for kid in res:
        if kid not in fwd_ids:
            res[kid]["library_ms"] = library_bwd
    set_counts(counts)
    (fwd90, (bwd90,)), (fwd, pair) = (train_kernel_ids(x, causal, rate)
                                      for x in ("sm90", "simple"))
    simple_pair = res[pair[0]]["ms"] + res[pair[1]]["ms"]
    print(f"A/B at the {'AR' if causal else 'FastSpeech 2'} train step's "
          f"input {tuple(q.shape)} rate {rate}: forward, Hopper design "
          f"({fwd90}) {res[fwd90]['ms']:.4f} ms against the simple design "
          f"({fwd}) {res[fwd]['ms']:.4f} ms "
          f"({res[fwd]['ms'] / res[fwd90]['ms']:.2f}x), SDPA "
          f"{library_fwd:.4f} ms, bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}); "
          f"{train_kernel_ids('sm90', causal, 0.0)[0]} at rate 0 "
          f"{rate0:.4f} ms; backward, fused ({bwd90}) "
          f"{res[bwd90]['ms']:.4f} ms against the simple pair "
          f"{simple_pair:.4f} ms ({simple_pair / res[bwd90]['ms']:.2f}x), "
          f"SDPA backward {library_bwd:.4f} ms, bound of the five products "
          f"{pair_bound[0]:.4f} ms ({pair_bound[1]}); saving per decoder "
          f"layer {res[fwd]['ms'] - res[fwd90]['ms'] + simple_pair - res[bwd90]['ms']:.4f} ms")
    return res


def relpos_train_kernel_timings(fwd_inputs, bwd_inputs) -> dict:
    """The relative kernels at the conformer train step's captured input
    (the first decoder layer): K4-d-90 and the fused K5-90 (the Hopper
    design it runs) and, in the same run, the simple design's K4-d, K5-dq
    and K5-dkdv on the same input (the A/B): kernel, plain and library
    ms, the bound, and each design against its fp32 plain version there
    (``check_relpos_train_kernels``), with the O the step's forward gave
    equal bit for bit to a second launch on the same seed. Library: SDPA
    with the relative bias precomputed and the same dropout for the
    forwards; for the backwards SDPA's backward with that bias requiring
    grad, plus the rel_shift adjoint of dbias and the two products that
    take it to dq_v and dP, each part timed, their sum the yardstick of
    every backward entry. Bounds per attended (row, key) pair: the forward 6*H*d, K5-dq
    10*H*d, K5-dkdv 12*H*d, the fused K5-90 16*H*d operations, against
    the bytes moved once."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    counts = read_counts()
    (q_u, q_v, k, v, p, k_len), fkw = fwd_inputs
    (bq_u, bq_v, bk, bv, bp, o, lse, do, bk_len), bkw = bwd_inputs
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    check(all(torch.equal(x, y) for x, y in ((q_u, bq_u), (q_v, bq_v),
                                            (k, bk), (v, bv), (p, bp),
                                            (k_len, bk_len)))
          and (bkw["dropout_rate"], bkw["dropout_seed"]) == (rate, seed),
          "the captured relative backward is not the captured forward's")
    checked = {}
    for design in ("sm90", "simple"):
        checked[design] = check_relpos_train_kernels(
            q_u, q_v, k, v, p, do, k_len, rate, seed,
            f" (train step input, {design})",
            design=None if design == "sm90" else "simple")
    check(torch.equal(checked["sm90"][2], o), "K4-d-90 gave another O on "
                                              "the same input and seed "
                                              "than in the train step")
    sm_scale = q_u.shape[-1] ** -0.5
    b, h, t, d = q_u.shape
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    in_bytes = 5 * plane + p.numel() * el + 2 * b * h * t * 4
    bias = relpos_bias(q_v, p, k_len, sm_scale)
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
    fwd_bound = bound_ms(6 * h * pairs * d,
                         5 * plane + p.numel() * el + b * h * t * 4,
                         q_u.dtype)
    pair_bound = bound_ms(16 * h * pairs * d,
                          in_bytes + 4 * plane + p.numel() * el, q_u.dtype)
    res = {}
    with torch.no_grad():
        plain_fwd = time_ms(lambda: fr.flash_relpos_attention_fwd_reference(
            q_u, q_v, k, v, p, k_len, sm_scale, rate, seed))
        library_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q_u, k, v, attn_mask=bias, dropout_p=rate, scale=sm_scale))
        rate0 = {}
        for kid, design, call in (
                ("K4-d-90", "sm90", fr.flash_relpos_attention),
                ("K4-d", "simple", partial(simple_flash_relpos_attention,
                                           sm_scale=sm_scale))):
            errs, peaks, _ = checked[design]
            res[kid] = {
                "ms": time_ms(lambda: call(q_u, q_v, k, v, p, k_len,
                                           dropout_rate=rate,
                                           dropout_seed=seed)),
                "plain_ms": plain_fwd, "library_ms": library_fwd,
                "max_abs_err": errs["o"], "max_abs_ref": peaks["o"]}
            res[kid]["bound_ms"], res[kid]["bound_by"] = fwd_bound
            rate0[kid] = time_ms(lambda: call(q_u, q_v, k, v, p, k_len))

        args = (q_u, q_v, k, v, p, do, lse, fr.bwd_delta(o, do), k_len)
        errs, peaks, _ = checked["sm90"]
        res["K5-90"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_sm90(
                *args, **kw)),
            "plain_ms": time_ms(
                lambda: fr.flash_relpos_attention_bwd_reference(
                    q_u, q_v, k, v, p, o, lse, do, k_len, sm_scale, rate,
                    seed)),
            **worst_err(errs, peaks, RELPOS_GRADS)}
        res["K5-90"]["bound_ms"], res["K5-90"]["bound_by"] = pair_bound
        errs, peaks, _ = checked["simple"]
        res["K5-dq"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dq(*args,
                                                                   **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dq_reference(
                *args, sm_scale, rate, seed)),
            **worst_err(errs, peaks, ("dq_u", "dq_v"))}
        res["K5-dq"]["bound_ms"], res["K5-dq"]["bound_by"] = bound_ms(
            10 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
        res["K5-dkdv"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dkdv(*args,
                                                                     **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dkdv_reference(
                *args, sm_scale, rate, seed)),
            **worst_err(errs, peaks, ("dk", "dv", "dp"))}
        res["K5-dkdv"]["bound_ms"], res["K5-dkdv"]["bound_by"] = bound_ms(
            12 * h * pairs * d, in_bytes + 2 * plane + p.numel() * el,
            q_u.dtype)
    lq, lk, lv, lbias = (x.detach().clone().requires_grad_()
                         for x in (q_u, k, v, bias))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lbias,
                                        dropout_p=rate, scale=sm_scale)
    parts = {"sdpa_bwd": time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv, lbias), do, retain_graph=True))}
    dbias = torch.autograd.grad(lo, lbias, do, retain_graph=True)[0]
    with torch.no_grad():
        parts["rel_shift_adjoint"] = time_ms(
            lambda: fr.rel_shift_adjoint(dbias))
        g = fr.rel_shift_adjoint(dbias)
        parts["products"] = time_ms(lambda: (
            torch.matmul(g, p), torch.einsum("bhij,bhid->hjd", g, q_v)))
    for kid in ("K5-90", "K5-dq", "K5-dkdv"):
        res[kid]["library_ms"] = sum(parts.values())
    set_counts(counts)
    for design, (errs, peaks, _) in checked.items():
        print(f"K4-d/K5 {design} vs plain at the conformer train step's "
              "input: " + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                   f"{peaks[n]:.3g})" for n, e in errs.items())
              + ("; O equal to the step's" if design == "sm90" else ""))
    print(f"A/B at the conformer train step's first decoder layer, rate "
          f"{rate}: K4-d-90 {res['K4-d-90']['ms']:.4f} ms against the simple "
          f"K4-d {res['K4-d']['ms']:.4f} ms "
          f"({res['K4-d']['ms'] / res['K4-d-90']['ms']:.2f}x); at rate 0 "
          f"K4-90 {rate0['K4-d-90']:.4f} ms against K4 {rate0['K4-d']:.4f} "
          f"ms; SDPA with the bias built {library_fwd:.4f} ms")
    simple_pair = res["K5-dq"]["ms"] + res["K5-dkdv"]["ms"]
    print(f"A/B of K5 at that input: the fused K5-90 {res['K5-90']['ms']:.4f} "
          f"ms against the simple pair K5-dq + K5-dkdv {simple_pair:.4f} ms "
          f"({simple_pair / res['K5-90']['ms']:.2f}x); the bound of the "
          f"pair {pair_bound[0]:.4f} ms ({pair_bound[1]}); library yardstick "
          + " + ".join(f"{n} {v:.4f}" for n, v in parts.items())
          + f" = {sum(parts.values()):.4f} ms")
    return res


def relpos_route(route: int, q_u, q_v, k, v, p, k_len, rate, seed):
    """The conformer's relative attention core, (o, lse): route 1 the
    relative kernels (K4/K4-d, and K5 behind autograd: in bf16 the Hopper
    design's K4-90/K4-d-90 and K5-90); route 2 the bias
    rel_shift(q_v P^T) built in device memory (unscaled, unmasked, in
    q_v's dtype), then K6/K6-d (and K6's backward, the bias's gradient
    going back through rel_shift and the product by autograd)."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    if route == 1:
        return fr.flash_relpos_attention(q_u, q_v, k, v, p, k_len, **kw)
    return fa.flash_attention_with_bias(q_u, k, v, relpos_route_bias(q_v, p),
                                        k_len, **kw)


def bias_kernel_timings(fwd_inputs, bwd_inputs) -> tuple:
    """K6 at the conformer train step's captured input (the first decoder
    layer: q_u, q_v, k, v, P, the batch's mel lengths, dropout 0.1 on the
    step's seed, dO from its backward), with the bias of route 2.

    The path that launches K6 is chip_smoke's route A/B: route 2 once
    forward at rate 0 (1 K6-90) and once forward and backward at the
    step's rate (1 K6-d-90, 1 K6-bwd-90), counted from 0, nothing else
    launched. Then each design against its fp32 plain version at that
    input (``check_bias_kernels``) and its kernel, plain and library ms
    and bound -- the Hopper design's K6-90, K6-d-90 and fused K6-bwd-90,
    and on the same input the simple design's K6, K6-d, K6-dq and K6-dkdv
    (the same-run A/B). Operations per attended (row, key) pair 4*H*d
    forward, 10*H*d the fused backward, 6*H*d dq, 8*H*d dk/dv; bytes q,
    k, v (and dO, lse, delta) read once, the bias read over the valid
    keys, o (dq, dk and dv) written once, dbias written whole. Library:
    SDPA with relpos_bias (the bias scaled and -inf-filled past k_len) as
    its mask, with the step's dropout for K6-d; for the backward entries
    SDPA's backward with the mask's gradient. Last the A/B of the two
    routes, forward and forward+backward. That the routes compute the
    same function is held in fp32, both routes on the card on the input's
    values: O and all five gradients of route 2 within 2e-2 of route 1's
    own max|ref|. In bf16 each route's differences from route 1's fp32
    results are printed: the conformer's gradients there are ~1e-7 sums
    that cancel, and a bf16 rounding of O moves delta = rowsum(dO O) in
    each route's backward by a few percent of them. Returns ({id:
    result}, {id: launches})."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    (q_u, q_v, k, v, p, k_len), fkw = fwd_inputs
    do = bwd_inputs[0][7]
    rate, seed = fkw["dropout_rate"], fkw["dropout_seed"]
    names = ("o",) + tuple(f"d{n}" for n in ("q_u", "q_v", "k", "v", "p"))
    xs = [x.detach().clone().requires_grad_() for x in (q_u, q_v, k, v, p)]
    xs32 = [x.detach().float().requires_grad_() for x in xs]

    def fwd_bwd(route, leaves=xs):
        o, _ = relpos_route(route, *leaves, k_len, rate, seed)
        return (o, *torch.autograd.grad(o, leaves, do.to(o.dtype)))

    set_counts({})                          # the path starts here
    with torch.no_grad():
        relpos_route(2, q_u, q_v, k, v, p, k_len, 0.0, 0)
    bf16_2 = fwd_bwd(2)
    torch.cuda.synchronize()
    launches = read_counts()                # and ends here
    want = {kid: 0 for kid in counters()}
    want.update({kid: 1 for kid in ("K6-90", "K6-d-90", "K6-bwd-90")})
    check(launches == want, f"the route A/B's K6 launches {launches}, "
                            f"expected {want}")
    counts = read_counts()
    bf16_1 = fwd_bwd(1)
    fp32_1, fp32_2 = fwd_bwd(1, xs32), fwd_bwd(2, xs32)
    torch.cuda.synchronize()
    agree = {}
    for name, r1, r2, x1, x2 in zip(names, fp32_1, fp32_2, bf16_1, bf16_2):
        peak = r1.abs().max().item()
        agree[name] = (max_err(r2, r1)[0] / peak,
                       max_err(x1, r1)[0] / peak, max_err(x2, r1)[0] / peak)
        check(agree[name][0] <= 2e-2,
              f"the two conformer routes disagree on {name} in fp32: "
              f"{agree[name][0]:.3g} of max|ref| {peak:.3g}")

    sm_scale = q_u.shape[-1] ** -0.5
    b, h, t, d = q_u.shape
    with torch.no_grad():
        bias = relpos_route_bias(q_v, p)
        checked = {}
        for design in ("sm90", "simple"):
            for r, sd in ((0.0, 0), (rate, seed)):
                checked[design, r] = check_bias_kernels(
                    q_u, k, v, bias, do, k_len, r, sd,
                    f" (conformer step input, {design})",
                    design=None if design == "sm90" else "simple")
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    bias_in = h * pairs * el                # the bias over the valid keys
    dbias_out = bias.numel() * el           # dbias written whole
    stats = b * h * t * 4
    in_bytes = 4 * plane + 2 * stats + bias_in  # q, k, v, dO, lse, delta
    fwd_bound = bound_ms(4 * h * pairs * d, 4 * plane + bias_in + stats,
                         q_u.dtype)
    mask = relpos_bias(q_v, p, k_len, sm_scale)
    res = {}
    with torch.no_grad():
        library_fwd = {r: time_ms(lambda: F.scaled_dot_product_attention(
            q_u, k, v, attn_mask=mask, dropout_p=r, scale=sm_scale))
            for r in (0.0, rate)}
        plain_fwd = {r: time_ms(lambda: fa.flash_attention_fwd_reference(
            q_u, k, v, k_len, sm_scale, r, seed, bias=bias))
            for r in (0.0, rate)}
        for design in ("sm90", "simple"):
            for r in (0.0, rate):
                kid = bias_kernel_ids(design, r)[0]
                e, pk, _ = checked[design, r]
                res[kid] = {
                    "ms": time_ms(lambda: fa._forward(
                        q_u, k, v, k_len, sm_scale, r, seed, False, bias,
                        design=None if design == "sm90" else "simple")),
                    "plain_ms": plain_fwd[r], "library_ms": library_fwd[r],
                    "max_abs_err": e["o"], "max_abs_ref": pk["o"]}
                res[kid]["bound_ms"], res[kid]["bound_by"] = fwd_bound
        o, lse = fa.flash_attention_with_bias(q_u, k, v, bias, k_len,
                                              dropout_rate=rate,
                                              dropout_seed=seed)
        args = (q_u, k, v, do, lse, fa.bwd_delta(o, do), k_len)
        kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
                  bias=bias)
        plain_dq = time_ms(lambda: fa.flash_attention_dq_reference(
            *args, sm_scale, rate, seed, bias=bias))
        plain_dkdv = time_ms(lambda: fa.flash_attention_dkdv_reference(
            *args, sm_scale, rate, seed, bias=bias))
        errs, peaks, _ = checked["sm90", rate]
        res["K6-bwd-90"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_sm90(*args, **kw)),
            "plain_ms": plain_dq + plain_dkdv,
            **worst_err(errs, peaks, BIAS_GRADS)}
        res["K6-bwd-90"]["bound_ms"], res["K6-bwd-90"]["bound_by"] = (
            bound_ms(10 * h * pairs * d,
                     in_bytes + 3 * plane + dbias_out, q_u.dtype))
        errs, peaks, _ = checked["simple", rate]
        res["K6-dq"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
            "plain_ms": plain_dq,
            **worst_err(errs, peaks, ("dq", "dbias"))}
        res["K6-dq"]["bound_ms"], res["K6-dq"]["bound_by"] = bound_ms(
            6 * h * pairs * d, in_bytes + plane + dbias_out, q_u.dtype)
        res["K6-dkdv"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
            "plain_ms": plain_dkdv,
            **worst_err(errs, peaks, ("dk", "dv"))}
        res["K6-dkdv"]["bound_ms"], res["K6-dkdv"]["bound_by"] = bound_ms(
            8 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
    lq, lk, lv, lmask = (x.detach().clone().requires_grad_()
                         for x in (q_u, k, v, mask))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv, lmask), do, retain_graph=True))
    for kid in ("K6-bwd-90", "K6-dq", "K6-dkdv"):
        res[kid]["library_ms"] = library_bwd

    ab = {}
    with torch.no_grad():
        ab["bias build"] = time_ms(lambda: relpos_route_bias(q_v, p))
        for route in (1, 2):
            ab[f"route {route} forward"] = time_ms(lambda: relpos_route(
                route, q_u, q_v, k, v, p, k_len, rate, seed))
    for route in (1, 2):
        ab[f"route {route} forward+backward"] = time_ms(
            lambda: fwd_bwd(route))
    set_counts(counts)
    for (design, r), (e, pk, _) in checked.items():
        print(f"K6 {design} vs plain at the conformer train step's input, "
              f"bias rel_shift(q_v P^T) {str(q_u.dtype)[6:]}, rate {r}: "
              + " ".join(f"max|d{n}|={x:.3g} (max|ref| {pk[n]:.3g})"
                         for n, x in e.items()))
    print("conformer routes at that input, each difference a share of "
          "route 1's fp32 max|ref|: route 2 against route 1 in fp32 (tol "
          "2e-2); route 1 and route 2 in bf16 against route 1 in fp32: "
          + ", ".join(f"{n} {a:.2e} | {b1:.2e} {b2:.2e}"
                      for n, (a, b1, b2) in agree.items()))
    print("conformer route A/B (route 1: K4-d-90, K5-90 behind autograd; "
          "route 2: the bias in device memory, K6-d-90, K6-bwd-90, the "
          "rel_shift adjoint and the products by autograd), dropout "
          f"{rate}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ab.items()))
    simple_pair = res["K6-dq"]["ms"] + res["K6-dkdv"]["ms"]
    print(f"A/B of K6 at that input: forward, K6-d-90 "
          f"{res['K6-d-90']['ms']:.4f} ms against the simple K6-d "
          f"{res['K6-d']['ms']:.4f} ms "
          f"({res['K6-d']['ms'] / res['K6-d-90']['ms']:.2f}x), SDPA "
          f"{library_fwd[rate]:.4f} ms; at rate 0 K6-90 "
          f"{res['K6-90']['ms']:.4f} ms against K6 {res['K6']['ms']:.4f} ms, "
          f"SDPA {library_fwd[0.0]:.4f} ms; bound {fwd_bound[0]:.4f} ms "
          f"({fwd_bound[1]}); backward, fused K6-bwd-90 "
          f"{res['K6-bwd-90']['ms']:.4f} ms against the simple pair "
          f"{simple_pair:.4f} ms ({simple_pair / res['K6-bwd-90']['ms']:.2f}"
          f"x), SDPA backward with the mask's gradient {library_bwd:.4f} "
          f"ms, bound {res['K6-bwd-90']['bound_ms']:.4f} ms "
          f"({res['K6-bwd-90']['bound_by']})")
    return res, launches


def relpos_route_bias(q_v, p):
    """Route 2's bias: rel_shift(q_v P^T), unscaled and unmasked, in q_v's
    dtype, contiguous (K6's input)."""
    from transformer_tts_tpu_torch.ops.flash_relpos import rel_shift
    return rel_shift(torch.matmul(q_v, p.transpose(-1, -2))).contiguous()


def causal_forward_timings(inputs) -> dict:
    """K3-f-90 and, on the same input, the simple design's K3-f (the A/B)
    at their path's captured input (the first decoder layer of the
    teacher-forced bf16 eval forward): kernel, plain and library (SDPA
    with the pad-and-causal mask) ms, the bound over the attended pairs,
    and O's error against the fp32 plain version on the same inputs, with
    O bit for bit on a second launch."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    (q, k, v, k_len), kw = inputs
    check(kw.get("causal") is True and kw.get("dropout_rate", 0.0) == 0.0,
          "the captured eval forward is not K3-f's")
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len, True)
    calls = {"K3-f-90": partial(fa.flash_attention, q, k, v, k_len,
                                causal=True),
             "K3-f": partial(simple_flash_attention, q, k, v, k_len,
                             sm_scale=sm_scale, causal=True)}
    bound = bound_ms(4 * h * attended_pairs(t_q, k_len, True) * d,
                     4 * q.numel() * q.element_size() + b * h * t_q * 4,
                     q.dtype)
    out = {}
    with torch.no_grad():
        ro, _ = fa.flash_attention_fwd_reference(
            *(x.float() for x in (q, k, v)), k_len, sm_scale, causal=True)
        plain_ms = time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, k_len, sm_scale, causal=True))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm_scale))
        for kid, call in calls.items():
            o, _ = call()
            again, _ = call()
            err, peak = max_err(o, ro)
            check(torch.equal(o, again) and err <= REL_TOL[q.dtype] * peak,
                  f"{kid} at its path's input: {err} against max|ref| "
                  f"{peak}, or another O on a second launch")
            out[kid] = {"ms": time_ms(call), "plain_ms": plain_ms,
                        "library_ms": library_ms, "max_abs_err": err,
                        "max_abs_ref": peak}
            out[kid]["bound_ms"], out[kid]["bound_by"] = bound
    set_counts(counts)
    print(f"A/B at the AR eval forward's first decoder layer "
          f"{tuple(q.shape)}: K3-f-90 {out['K3-f-90']['ms']:.4f} ms against "
          f"the simple K3-f {out['K3-f']['ms']:.4f} ms "
          f"({out['K3-f']['ms'] / out['K3-f-90']['ms']:.2f}x), SDPA "
          f"{library_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]})")
    return out


# ---- phase 8: attention paths -----------------------------------------------

ATTENTION_PATH_T = (128, 256, 768, 2048)
RELPOS_PATH_T = (128, 256, 512, 1024, 2048)
CAUSAL_PATH_T = (128, 256, AR_GROUPS, 1024, 2048)


def forward_backward_ms(fn, tensors, do) -> float:
    """Device ms of ``fn(*tensors)`` (its first output) and the gradients
    of ``(out * do).sum()`` with respect to every tensor."""
    leaves = [x.detach().clone().requires_grad_() for x in tensors]

    def run():
        out = fn(*leaves)[0]
        torch.autograd.grad(out, leaves, do)
    return time_ms(run)


def phase_attention_paths(gen):
    """Kernel path against masked-fill path at B=8, H=4, d=96 in bf16: the
    transformer's forward (K1-90) at T in ATTENTION_PATH_T; the
    conformer's forward (K4-90) at T in RELPOS_PATH_T; then the AR
    decoder's causal self-attention at T in CAUSAL_PATH_T, forward
    (K3-f-90) and forward with backward (K3-f-90 and K3-90), against the
    masked-fill path on the pad-and-causal mask."""
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
    from transformer_tts_tpu_torch.ops.flash_relpos import (
        flash_relpos_attention)
    counts = read_counts()
    for t in ATTENTION_PATH_T:
        q, k, v = (x.to(torch.bfloat16) for x in
                   kernel_inputs("K1", gen, 8, 4, t, t, 96))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        times = [time_ms(lambda: flash_attention(q, k, v, k_len)),
                 time_ms(lambda: attention.scaled_dot_attention(q, k, v,
                                                                mask))]
        print(f"attention B=8 H=4 d=96 bf16 T={t}: K1 path (the Hopper "
              f"design) {times[0]:.4f} ms, masked-fill path {times[1]:.4f} "
              f"ms")
    for t in RELPOS_PATH_T:
        q_u, q_v, k, v, p = (x.to(torch.bfloat16) for x in
                             kernel_inputs("K4", gen, 8, 4, t, t, 96))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        times = [time_ms(lambda: flash_relpos_attention(q_u, q_v, k, v, p,
                                                        k_len)),
                 time_ms(lambda: attention.relative_dot_attention(
                     q_u, q_v, k, v, p[None], mask))]
        print(f"relative attention B=8 H=4 d=96 bf16 T={t}: K4 path (the "
              f"Hopper design, K4-90) {times[0]:.4f} ms, relative "
              f"masked-fill path {times[1]:.4f} ms")
    for t in CAUSAL_PATH_T:
        q, k, v, do = (torch.randn(8, 4, t, 96, generator=gen).to(
            DEVICE, torch.bfloat16) for _ in range(4))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = sdpa_mask(t, t, k_len, True)[:, 0]      # (B, T, T)
        kernel = partial(flash_attention, k_len=k_len, causal=True)
        masked = partial(attention.scaled_dot_attention, mask=mask)
        with torch.no_grad():
            fwd = [time_ms(lambda: kernel(q, k, v)),
                   time_ms(lambda: masked(q, k, v))]
        both = [forward_backward_ms(kernel, (q, k, v), do),
                forward_backward_ms(masked, (q, k, v), do)]
        print(f"causal attention B=8 H=4 d=96 bf16 T={t}: forward, K3 path "
              f"(K3-f-90) {fwd[0]:.4f} ms, masked-fill path {fwd[1]:.4f} "
              f"ms; forward and backward, K3 path (K3-f-90 + K3-90) "
              f"{both[0]:.4f} ms, masked-fill path {both[1]:.4f} ms")
    set_counts(counts)


def worst_err(errs: dict, peaks: dict, names) -> dict:
    """The error of the entry's worst output among ``names``, the one
    with the largest err / max|ref|: its max abs error, its own max|ref|
    and its name (``worst``), so the pair describes one tensor."""
    def share(n):
        if peaks[n]:
            return errs[n] / peaks[n]
        return float("inf") if errs[n] else 0.0
    n = max(names, key=share)
    return {"max_abs_err": errs[n], "max_abs_ref": peaks[n], "worst": n}


def of_tensor(res: dict) -> str:
    return f", of {res['worst']}" if "worst" in res else ""


def kernels_line_entry(name, source, replaces, launches, res) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]}


PHASE_TIMES = []


@contextmanager
def phase(name: str):
    """Print the wall time of the phase ``name`` once it ends."""
    t0 = time.perf_counter()
    yield
    PHASE_TIMES.append((name, time.perf_counter() - t0))
    print(f"[phase {name}: {PHASE_TIMES[-1][1]:.1f} s]", flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    from transformer_tts_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    registry = kernels()
    names = sorted({entry[2] for entry in registry.values()}
                   | {"flash_attention_bwd", "flash_relpos_bwd",
                      "flash_bwd_sm90", "flash_relpos_bwd_sm90"})
    with phase("build"):
        cuda_build.build(names)
    print("build seconds (all started together): " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in cuda_build.BUILD_SECONDS.items()))
    for name in names:
        for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "Used" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {name}:", line.strip())

    gen = torch.Generator().manual_seed(0)
    b, text_len, mel_len, frames = TRAIN_BATCH
    batch = train_batch(gen, train_hparams(), b, text_len, mel_len, frames,
                        DEVICE)
    ar_hp = ar_hparams()
    ar_batch = ar_train_batch(gen, ar_hp, b, text_len, mel_len, frames,
                              DEVICE)
    r = ar_hp.reduction_rate
    ar_groups = (ar_batch["pos_mel"][:, :-r:r] > 0).sum(1)
    with phase("kernels vs plain"):
        phase_kernel_vs_plain(gen)
        phase_train_kernels_vs_plain(gen, (batch["pos_mel"] > 0).sum(1))
    with phase("K3 vs plain"):
        phase_causal_kernels_vs_plain(gen, ar_groups)
    with phase("K4 and K5 vs plain"):
        phase_relpos_kernels_vs_plain(gen, (batch["pos_mel"] > 0).sum(1))
    with phase("K6 vs plain"):
        phase_bias_kernels_vs_plain(gen)
    main_runs = {}
    for name, (stacks, kid) in PATHS.items():
        with phase(f"{name} synthesis"):
            phase_teacher_forced(gen, name, stacks)
            hp, model, launches, main_inputs = phase_synthesis(
                gen, name, stacks, kid)
            phase_cli(name, stacks, hp, model)
            main_runs[kid] = (launches, main_inputs)
            del model
            torch.cuda.empty_cache()
    with phase("fastspeech2 training"):
        phase_card_vs_cpu(gen, "fastspeech2")
        train_launches, fwd_inputs, bwd_inputs = phase_train_step(
            batch, "fastspeech2")
        phase_train_cli(gen, "fastspeech2")
    with phase("conformer training"):
        phase_card_vs_cpu(gen, "conformer")
        conf_launches, conf_fwd_inputs, conf_bwd_inputs = phase_train_step(
            batch, "conformer")
        phase_train_cli(gen, "conformer")
    with phase("AR eval forward and decode"):
        k3f_launches, k3f_inputs = phase_ar_teacher_forced(gen)
        phase_ar_decode_vs_forward(gen)
    with phase("AR synthesis"):
        phase_ar_synthesis(gen)
    with phase("AR training"):
        phase_card_vs_cpu(gen, "ar")
        ar_launches, ar_fwd_inputs, ar_bwd_inputs = phase_train_step(
            ar_batch, "ar")
        phase_train_cli(gen, "ar")

    lines = []
    with phase("kernels at their main paths' inputs"):
        for path_kid, (launches, main_inputs) in main_runs.items():
            tensors, k_len = list(main_inputs[:-1]), main_inputs[-1]
            # the transformer's path runs K1-90, the conformer's K4-90; the
            # simple K1 and K4 are timed on the same input for the A/B
            simple = path_kid[:-len("-90")]
            ab = {}
            for kid in (path_kid, simple):
                res = ab[kid] = kernel_timings(kid, tensors, k_len)
                print(f"{kid} at the main path's input "
                      f"{tuple(tensors[0].shape)} "
                      f"{str(tensors[0].dtype)[6:]}, k_len "
                      f"{k_len.tolist()}: kernel {res['ms']:.4f} ms, plain "
                      f"{res['plain_ms']:.4f} ms, library "
                      f"{res['library_ms']:.4f} ms, bound "
                      f"{res['bound_ms']:.4f} ms ({res['bound_by']}), "
                      f"max|dO| {res['max_abs_err']:.3g}, launches "
                      f"{launches[kid]}")
                if "bias_ms" in res:
                    print(f"{kid} library yardstick leaves out building its "
                          f"bias: {res['bias_ms']:.4f} ms")
                _, _, name, source, replaces, _ = registry[kid]
                lines.append(kernels_line_entry(name, source, replaces,
                                                launches[kid], res))
            print(f"A/B at the B=8 synthesis call's first decoder "
                  f"layer: {path_kid} {ab[path_kid]['ms']:.4f} ms against "
                  f"the simple {simple} {ab[simple]['ms']:.4f} ms "
                  f"({ab[simple]['ms'] / ab[path_kid]['ms']:.2f}x), SDPA "
                  f"{ab[path_kid]['library_ms']:.4f} ms")
        runs = {}                 # id -> (result, launches, its input)
        for kid, res in train_kernel_timings(fwd_inputs,
                                             bwd_inputs).items():
            runs[kid] = (res, train_launches[kid], fwd_inputs)
        for kid, res in train_kernel_timings(ar_fwd_inputs, ar_bwd_inputs,
                                             causal=True).items():
            runs[kid] = (res, ar_launches[kid], ar_fwd_inputs)
        for kid, res in causal_forward_timings(k3f_inputs).items():
            runs[kid] = (res, k3f_launches[kid], k3f_inputs)
        for kid, res in relpos_train_kernel_timings(
                conf_fwd_inputs, conf_bwd_inputs).items():
            runs[kid] = (res, conf_launches[kid], conf_fwd_inputs)
        for kid, (_, _, name, source, replaces) in train_kernels().items():
            res, launches, (args, kw) = runs[kid]
            q, k_len = args[0], args[-1]
            print(f"{kid} at its path's input {tuple(q.shape)} "
                  f"{str(q.dtype)[6:]} rate {kw.get('dropout_rate', 0.0)}, "
                  f"k_len {k_len.tolist()}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library "
                  f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
                  f"ms ({res['bound_by']}), max abs err "
                  f"{res['max_abs_err']:.3g} (max|ref| "
                  f"{res['max_abs_ref']:.3g}{of_tensor(res)}), launches "
                  f"{launches}")
            lines.append(kernels_line_entry(name, source, replaces,
                                            launches, res))
        bias_res, bias_launches = bias_kernel_timings(conf_fwd_inputs,
                                                      conf_bwd_inputs)
        q, k_len = conf_fwd_inputs[0][0], conf_fwd_inputs[0][-1]
        for kid, (_, _, name, source, replaces) in bias_kernels().items():
            res = bias_res[kid]
            print(f"{kid} at the conformer step's input {tuple(q.shape)} "
                  f"{str(q.dtype)[6:]}, k_len {k_len.tolist()}: kernel "
                  f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
                  f"library {res['library_ms']:.4f} ms, bound "
                  f"{res['bound_ms']:.4f} ms ({res['bound_by']}), max abs "
                  f"err {res['max_abs_err']:.3g} (max|ref| "
                  f"{res['max_abs_ref']:.3g}{of_tensor(res)}), launches in "
                  f"the route A/B "
                  f"{bias_launches[kid]}")
            lines.append(kernels_line_entry(name, source, replaces,
                                            bias_launches[kid], res))
    with phase("attention paths"):
        phase_attention_paths(gen)
    with phase("profiles"):
        for run_profile in PROFILES:
            run_profile()

    print("phase wall times: " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in PHASE_TIMES)
        + f"; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": lines}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
