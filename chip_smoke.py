#!/usr/bin/env python3
"""Drive the PyTorch port's FastSpeech 2 (transformer and conformer) and AR
Transformer-TTS synthesis and training on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and ``nvcc``; exits
non-zero, printing no result, without them. Phases, each fatal on failure
and each printing its wall time:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the paths (K1 and K1-d with K3's and K6's
   forward, K2 with K3's and K6's backward, K4 and K4-d, K5), in
   parallel, from the sources in the checkout;
3. each kernel against its plain PyTorch version on the card, TF32 off:
   K1 (csrc/flash_attention_fwd.cu) and K4 (csrc/flash_relpos_fwd.cu):
   fp32 at 1e-4 on O and lse, bf16 against the plain version in fp32 on
   the same bf16 inputs at 2e-2 on O and 1e-3 on lse, rows with no valid
   key exactly 0; kernel, plain and library times at the synthesis shapes.
   K1-d (dropout 0.1) and K2 (csrc/flash_attention_bwd.cu, at dropout 0
   and 0.1 on the same seed) at k_len in {0, 1, 65, T}, T = 1000,
   T_q = 300 != T_k = 700, and the train step's (16, 4, 1024, 96) with
   its batch's mel lengths as k_len: O, dq, dk, dv at 1e-4 (fp32) and
   2e-2 (bf16) times that tensor's own max|ref|, lse as K1; dk and dv
   exactly 0 for keys at or past k_len. K3, the causal mode of the same
   kernels, likewise at the AR train step's (16, 4, 511, 96) with k_len
   1, 65, T and the AR batch's decoder groups, and at T_q != T_k both
   ways. K4-d (csrc/flash_relpos_fwd.cu with dropout) and K5
   (csrc/flash_relpos_bwd.cu, dq and dk/dv/dP) at dropout 0 and 0.1 on
   the same seed, at k_len in {0, 1, 65, T}, T = 1000, and the conformer
   train step's (16, 4, 1024, 96) with its batch's mel lengths: O, dq_u,
   dq_v, dk, dv and dP at 1e-4 (fp32) and 2e-2 (bf16) of each tensor's
   own max|ref|, dk and dv exactly 0 past k_len, O bit for bit the same
   on a second call. K6/K6-d (the bias argument of
   csrc/flash_attention_fwd.cu) and K6's backward (dq with dbias, dk/dv,
   csrc/flash_attention_bwd.cu) likewise at k_len in {0, 1, 65, T}, T =
   1000, and T_q = 300 != T_k = 700: O, dq, dk, dv and dbias, dbias, dk
   and dv exactly 0 past k_len;
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
       the path's kernel per call, one per decoder layer, and none of the
       others), with ms and RTF;
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
       set to 0 just before (6 K1-d, 6 K2 dq and 6 K2 dk/dv per step, no
       other kernel); ms/step, mel frames/s, peak memory; the loss
       finite; 3 steps under torch.profiler, printing the top 10 device
       operations (run in phase 9); then 20 steps with warmup_step 100
       whose loss must fall;
   (c) cli/train.py for 3 steps on a synthetic corpus (32 utterances of
       300-900 frames) and cli/synthesize.py on the checkpoint it saved;
   (d)-(f) the conformer flagship's training likewise: the card-vs-CPU
       step (decoder on K4 and K5; its decoder self-attention weights,
       linear_pos and the position biases at the attention tolerance,
       each with a non-zero card gradient), the timed step (6 K4-d, 6 K5
       dq and 6 K5 dk/dv per step, no other kernel) and its profile, the
       two CLIs;
6. the AR Transformer-TTS flagship of egs/transformer_tts_ljspeech.py
   (the same widths, r 2, prenet dropout 0.5), each path counted from 0:
   (a) the teacher-forced eval forward over 300 decoder groups, 6 K3-f
       launches and nothing else, card fp32 against the CPU at 1e-3 and
       bf16 amp at 5e-2 of max(1, max|ref|);
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
       K3-f and K3's backward), the timed step (6 K3-d, 6 K3 dq and 6 K3
       dk/dv per step, no other kernel), the two CLIs;
7. each kernel at its main path's own captured input (K1, K4: the first
   decoder layer of the B=8 synthesis call; K1-d and K2, K3-d and K3's
   backward: the first decoder layer of the FastSpeech 2 and the AR train
   step, held there against their plain versions as in 3; K4-d and K5:
   the first decoder layer of the conformer train step, likewise, the
   library yardstick SDPA with the relative bias (for K5 its backward
   with the bias's gradient, the rel_shift adjoint and two products);
   K3-f: the first decoder layer of 6(a)'s bf16 forward): kernel, plain
   and library ms, bound (for K3 over the causal pairs the inputs
   attend), error. K6, K6-d and K6's backward at the conformer step's
   input with the bias rel_shift(q_v P^T) built in device memory: the
   path that launches them is the route A/B of the conformer's attention
   core (route 1 K4-d and K5, route 2 the bias then K6), counted from 0,
   O and the five gradients of the two routes within 2e-2 of each one's
   max|ref|, and the routes' forward and forward+backward times;
8. attention-path timing, kernel against masked-fill, at T in
   {128, 256, 768, 2048}, for both attention modules;
9. the profiles of 5(b), 5(e), 6(c) and 6(e), each on a state or model
   built anew, after every timed phase: a profiler pass slows the host
   work of the rest of its process.

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
    "transformer": ({}, "K1"),
    "conformer": ({"encoder_type": "conformer",
                   "decoder_type": "conformer"}, "K4"),
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


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernels():
    """Id -> (wrapper, plain version, the wrapper's name in
    ops/attention.py, source, TPU kernel it replaces)."""
    from transformer_tts_tpu_torch.ops import flash_attention as k1
    from transformer_tts_tpu_torch.ops import flash_relpos as k4
    return {
        "K1": (k1.flash_attention, k1.flash_attention_fwd_reference,
               k1.KERNEL, "transformer_tts_tpu_torch/csrc/"
               "flash_attention_fwd.cu",
               "transformer_tts_tpu/ops/flash_attention.py:90"),
        "K4": (k4.flash_relpos_attention,
               k4.flash_relpos_attention_fwd_reference, k4.KERNEL,
               "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu",
               "transformer_tts_tpu/ops/flash_relpos.py:212"),
    }


def train_kernels():
    """Id -> (object holding the launch count, its attribute, the entry's
    name in the kernels line, source, TPU kernel it replaces) for the
    kernels of the training path."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    rp_fwd = "transformer_tts_tpu_torch/csrc/flash_relpos_fwd.cu"
    rp_bwd = "transformer_tts_tpu_torch/csrc/flash_relpos_bwd.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    jax_rp = "transformer_tts_tpu/ops/flash_relpos.py"
    return {
        "K1-d": (fa.flash_attention, "dropout_launches",
                 "flash_attention_fwd dropout", fwd, f"{jax_fa}:90"),
        "K2-dq": (fa.flash_attention_bwd_dq, "launches",
                  "flash_attention_bwd dq", bwd, f"{jax_fa}:266"),
        "K2-dkdv": (fa.flash_attention_bwd_dkdv, "launches",
                    "flash_attention_bwd dk/dv", bwd, f"{jax_fa}:344"),
        # K3: the causal mode of the same kernels (the AR decoder)
        "K3-f": (fa.flash_attention, "causal_launches",
                 "flash_attention_fwd causal", fwd, f"{jax_fa}:138"),
        "K3-d": (fa.flash_attention, "causal_dropout_launches",
                 "flash_attention_fwd causal dropout", fwd, f"{jax_fa}:138"),
        "K3-dq": (fa.flash_attention_bwd_dq, "causal_launches",
                  "flash_attention_bwd causal dq", bwd, f"{jax_fa}:306"),
        "K3-dkdv": (fa.flash_attention_bwd_dkdv, "causal_launches",
                    "flash_attention_bwd causal dk/dv", bwd,
                    f"{jax_fa}:379"),
        # the conformer decoder: K4 with dropout, and its backward K5 (the
        # TPU's _dq_kernel and _dkdv_kernel; _fused_bwd_kernel :510 is the
        # same function at one k block)
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
    bias in device memory (phase 7's route A/B)."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    fwd = "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu"
    bwd = "transformer_tts_tpu_torch/csrc/flash_attention_bwd.cu"
    jax_fa = "transformer_tts_tpu/ops/flash_attention.py"
    return {
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
    out = {kid: (entry[0], "launches") for kid, entry in kernels().items()}
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
    q, k = tensors[0], tensors[1 if kid == "K1" else 2]
    b, h, t_q, d = q.shape
    keys = k_len.clamp(max=k.shape[2]).double().sum().item()
    per_key = 6.0 if kid == "K4" else 4.0
    moved = sum(x.numel() for x in tensors) + q.numel()     # inputs, o
    nbytes = moved * q.element_size() + b * h * t_q * 4 + k_len.numel() * 4
    return bound_ms(per_key * h * t_q * keys * d, nbytes, q.dtype)


# ---- phase 3: the kernels against their plain versions ----------------------

def kernel_errors(kid, tensors, k_len):
    """(err_o, err_lse) of the kernel against the fp32 plain version on the
    same inputs; fails unless rows with no valid key are exactly 0."""
    from transformer_tts_tpu_torch.ops.flash_attention import NEG_INF
    kernel, plain = kernels()[kid][:2]
    sm_scale = tensors[0].shape[-1] ** -0.5
    o, lse = kernel(*tensors, k_len, sm_scale=sm_scale)
    torch.cuda.synchronize()
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
    if kid == "K1":
        shapes = [(b, h, t_q, d), (b, h, t_k, d), (b, h, t_k, d)]
    else:                               # q_u, q_v, k, v, p
        shapes = [(b, h, t_q, d)] * 4 + [(h, t_q, d)]
    return [torch.randn(s, generator=gen).to(DEVICE) for s in shapes]


def phase_kernel_vs_plain(gen):
    cases = {  # (B, H, T_q, T_k, d, k_len)
        "K1": [(1, 4, 768, 768, 96, [768]),
               (8, 4, 2048, 2048, 96, [2048, 0, 1000, 1, 2047, 64, 65,
                                       1500]),
               (2, 4, 1000, 1000, 96, [1000, 333]),         # ragged T
               (2, 4, 300, 700, 96, [700, 0])],              # T_q != T_k
        "K4": [(1, 4, 768, 768, 96, [768]),
               (8, 4, 2048, 2048, 96, [2048, 0, 1, 64, 65, 2047, 1000,
                                       1500]),
               (2, 4, 1000, 1000, 96, [1000, 333]),         # ragged T
               (2, 4, 257, 257, 96, [257, 3])],             # just over 256
    }
    for kid, kid_cases in cases.items():
        for b, h, t_q, t_k, d, k_len in kid_cases:
            tensors = kernel_inputs(kid, gen, b, h, t_q, t_k, d)
            kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
            for dtype, (tol_o, tol_lse) in TOLS.items():
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


def check_train_kernels(q, k, v, do, k_len, rate, seed=DROPOUT_SEED,
                        label="", causal=False) -> tuple:
    """K1/K1-d and K2 (with ``causal`` K3's forward and backward) on
    (q, k, v, do) against the plain versions in fp32 on the same inputs.
    O, dq, dk and dv must agree within REL_TOL times that tensor's own
    max |ref| (the gradients reaching the decoder's attention in training
    are ~1e-7), lse within TOLS' absolute limit; dk and dv exactly 0 for
    keys at or past k_len. Returns ({name: max abs err}, {name: max |ref|},
    o). Launch counts are left as they were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    fwd, bwd = ("K3", "K3") if causal else ("K1-d", "K2")
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, k_len, dropout_rate=rate,
                                    dropout_seed=seed, causal=causal)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, k_len,
                                       sm_scale=sm_scale, dropout_rate=rate,
                                       dropout_seed=seed, causal=causal)
        torch.cuda.synchronize()
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
    (16, 4, 1024, 96) with its batch's mel lengths as k_len; fp32 (TF32
    off) and bf16; dropout 0 and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    cases = [(4, 4, 1000, 1000, 96, [1000, 0, 1, 65]),
             (2, 4, 300, 700, 96, [700, 65]),
             (b_train, 4, t_train, t_train, 96, train_k_len.tolist())]
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate)
                print(f"K1-d/K2 vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if b <= 4 else 'the train batch'}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


AR_GROUPS = 511                 # decoder groups at the 1024-frame bucket


def phase_causal_kernels_vs_plain(gen, ar_k_len):
    """K3 (the causal forward at rates 0 and 0.1, its dq and dk/dv)
    against its plain versions: (16, 4, 511, 96), the AR train step's
    shape, with k_len in {1, 65, T} and the rest of the rows the AR
    batch's decoder groups; T_q != T_k both ways; fp32 (TF32 off) and
    bf16, O, dq, dk and dv each within REL_TOL of its own max|ref|, lse
    as K1's; dk and dv exactly 0 past k_len."""
    b_train = TRAIN_BATCH[0]
    k_len = ([AR_GROUPS, 1, 65] + ar_k_len.tolist())[:b_train]
    cases = [(b_train, 4, AR_GROUPS, AR_GROUPS, 96, k_len),
             (2, 4, 300, 700, 96, [700, 65]),
             (2, 4, 700, 300, 96, [300, 1])]
    for b, h, t_q, t_k, d, kl in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        kl = torch.tensor(kl, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_train_kernels(
                    *(x.to(dtype) for x in (q, k, v, do)), kl, rate,
                    causal=True)
                cases_k = (kl.tolist() if b <= 4
                           else "1, 65, T and the AR batch's")
                print(f"K3 vs plain ({b},{h},{t_q},{t_k},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len={cases_k}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


RELPOS_GRADS = ("dq_u", "dq_v", "dk", "dv", "dp")


def check_relpos_train_kernels(q_u, q_v, k, v, p, do, k_len, rate,
                               seed=DROPOUT_SEED, label="") -> tuple:
    """K4 (rate 0) or K4-d and K5 on (q_u, q_v, k, v, p, do) against their
    plain versions in fp32 on the same inputs: O, dq_u, dq_v, dk, dv and
    dp each within REL_TOL of its own max|ref|, lse within TOLS' absolute
    limit; dk and dv exactly 0 for keys at or past k_len; O bit for bit
    the same on a second call with the same seed. Returns ({name: max abs
    err}, {name: max|ref|}, o). Launch counts are left as they were."""
    from transformer_tts_tpu_torch.ops import flash_relpos as fr
    counts = read_counts()
    sm_scale = q_u.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    with torch.no_grad():
        o, lse = fr.flash_relpos_attention(q_u, q_v, k, v, p, k_len, **kw)
        o_again, _ = fr.flash_relpos_attention(q_u, q_v, k, v, p, k_len,
                                               **kw)
        grads = fr.flash_relpos_attention_bwd(q_u, q_v, k, v, p, o, lse, do,
                                              k_len, sm_scale=sm_scale, **kw)
        torch.cuda.synchronize()
        f = [x.float() for x in (q_u, q_v, k, v, p)]
        ro, rlse = fr.flash_relpos_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed)
        ref = fr.flash_relpos_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed)
    set_counts(counts)
    fwd = "K4-d" if rate > 0 else "K4"
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
              f"K5 {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    for name, g in (("dk", grads[2]), ("dv", grads[3])):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b, :, n:] == 0).all()),
                  f"K5 {name}{label} is not exactly 0 for keys at or past "
                  f"k_len")
    return errs, peaks, o


def phase_relpos_kernels_vs_plain(gen, train_k_len):
    """K4-d and K5 against their plain versions: k_len in {0, 1, 65, T}
    at T = 1000 (not a multiple of the tiles), and the conformer train
    step's shape (16, 4, 1024, 96) with its batch's mel lengths as k_len;
    fp32 (TF32 off) and bf16; dropout 0 and 0.1 on the same seed."""
    b_train, _, t_train, _ = TRAIN_BATCH
    cases = [(4, 4, 1000, 96, [1000, 0, 1, 65]),
             (b_train, 4, t_train, 96, train_k_len.tolist())]
    for b, h, t, d, k_len in cases:
        q_u, q_v, k, v, do = (torch.randn(b, h, t, d, generator=gen)
                              .to(DEVICE) for _ in range(5))
        p = torch.randn(h, t, d, generator=gen).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_relpos_train_kernels(
                    *(x.to(dtype) for x in (q_u, q_v, k, v, p, do)), kl,
                    rate)
                print(f"K4-d/K5 vs plain ({b},{h},{t},{d}) "
                      f"{str(dtype)[6:]} rate {rate} k_len="
                      f"{k_len if b <= 4 else 'the train batch'}: "
                      + " ".join(f"max|d{n}|={e:.3g} (max|ref| "
                                 f"{peaks[n]:.3g})" for n, e in errs.items()))


BIAS_GRADS = ("dq", "dk", "dv", "dbias")


def check_bias_kernels(q, k, v, bias, do, k_len, rate, seed=DROPOUT_SEED,
                       label="") -> tuple:
    """K6 (rate 0) or K6-d and K6's backward on (q, k, v, bias, do) against
    their plain versions in fp32 on the same inputs: O, dq, dk, dv and
    dbias each within REL_TOL of its own max|ref|, lse within TOLS'
    absolute limit; dbias, dk and dv exactly 0 for keys at or past k_len
    (dbias on every row); O bit for bit the same on a second call with
    the same seed. Returns ({name: max abs err}, {name: max|ref|}, o).
    Launch counts are left as they were."""
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    kw = dict(dropout_rate=rate, dropout_seed=seed)
    with torch.no_grad():
        o, lse = fa.flash_attention_with_bias(q, k, v, bias, k_len, **kw)
        o_again, _ = fa.flash_attention_with_bias(q, k, v, bias, k_len, **kw)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, k_len,
                                       sm_scale=sm_scale, bias=bias, **kw)
        torch.cuda.synchronize()
        f = [x.float() for x in (q, k, v)]
        ro, rlse = fa.flash_attention_fwd_reference(
            *f, k_len, sm_scale, rate, seed, bias=bias.float())
        ref = fa.flash_attention_bwd_reference(
            *f, o.float(), lse, do.float(), k_len, sm_scale, rate, seed,
            bias=bias.float())
    set_counts(counts)
    fwd = "K6-d" if rate > 0 else "K6"
    check(torch.equal(o, o_again), f"{fwd}{label}: another O on a second "
                                   f"call with the same seed")
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
              f"K6 {name}{label} disagrees with its plain version: "
              f"{errs[name]} > {rel} * max|ref| {peaks[name]}")
    check(grads[3].dtype == bias.dtype, f"K6 dbias{label} is not in the "
                                        f"bias's dtype")
    for name, g, axis in (("dk", grads[1], 2), ("dv", grads[2], 2),
                          ("dbias", grads[3], 3)):
        for b, n in enumerate(k_len.tolist()):
            check(bool((g[b].narrow(axis - 1, n, g.shape[axis] - n) == 0)
                       .all()),
                  f"K6 {name}{label} is not exactly 0 for keys at or past "
                  f"k_len")
    return errs, peaks, o


def phase_bias_kernels_vs_plain(gen):
    """K6/K6-d and K6's backward (dq with dbias, dk/dv) against their plain
    versions: k_len in {0, 1, 65, T} at T = 1000, and T_q = 300 != T_k =
    700 (whose T_k takes the bf16 bias tiles element by element: 700 is
    not a multiple of 8); fp32 (TF32 off) and bf16; dropout 0 and 0.1 on
    the same seed; a random bias of scale 2."""
    cases = [(4, 4, 1000, 1000, 96, [1000, 0, 1, 65]),
             (2, 4, 300, 700, 96, [700, 65])]
    for b, h, t_q, t_k, d, k_len in cases:
        q, do = (torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
                 for _ in range(2))
        k, v = (torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
                for _ in range(2))
        bias = (2 * torch.randn(b, h, t_q, t_k, generator=gen)).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.1):
                errs, peaks, _ = check_bias_kernels(
                    *(x.to(dtype) for x in (q, k, v, bias, do)), kl, rate)
                print(f"K6 vs plain ({b},{h},{t_q},{t_k},{d}) "
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
    launches = kernel.launches
    res = {
        "ms": time_ms(lambda: kernel(*tensors, k_len, sm_scale=sm_scale)),
        "plain_ms": time_ms(lambda: plain(*tensors, k_len, sm_scale)),
    }
    if kid == "K1":
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
    # these launches are not launches of the main path
    kernel.launches = launches
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
    return hp, model, launches[kid], main_inputs


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
    kernel-path attention, the ids of the kernels that carry it (forward
    at rate 0, forward with dropout, dq, dk/dv), and the (module, name)
    of the kernel path's forward and backward entries, whose calls the
    timed step captures."""
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
                    kernels=("K1", "K1-d", "K2-dq", "K2-dkdv"), **calls)
    if kind == "conformer":
        return dict(hparams=conformer_hparams,
                    init=tr.init_fastspeech2_state,
                    make_step=tr.make_fastspeech2_train_step,
                    batch=train_batch, attn="attn", no_dropout=fs2_no_dropout,
                    kernels=("K4", "K4-d", "K5-dq", "K5-dkdv"),
                    fwd_call=(attention, "flash_relpos_attention"),
                    bwd_call=(fr, "flash_relpos_attention_bwd"))
    return dict(hparams=ar_hparams, init=tr.init_transformer_state,
                make_step=tr.make_transformer_train_step,
                batch=ar_train_batch, attn="attn_1",
                no_dropout=dict(dropout=0.0, dropout_prenet=0.0,
                                dropout_postnet=0.0),
                kernels=("K3-f", "K3-d", "K3-dq", "K3-dkdv"), **calls)


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


def ulp(x: torch.Tensor) -> torch.Tensor:
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, math.inf)) - a


def phase_card_vs_cpu(gen, kind):
    """One train step on the card and on the CPU from the same weights:
    the flagship in fp32 with every dropout 0, where the decoder takes K1
    and K2 (FastSpeech 2), K4 and K5 (the conformer) or K3 and its
    backward (the AR model, 383 decoder groups); then the same step with
    bf16 amp on the card. Every decoder attention weight's card gradient
    must be non-zero.
    warmup_step 10 makes Adam's first update lr * g / (|g| + 1e-9) ~
    lr * sign(g) with lr = 1.6e-3, far above fp32's rounding of the
    weights, so the updates show every gradient's sign, however small the
    gradient."""
    spec = trainer(kind)
    b, text_len, mel_len, frames = CPU_STEP_BATCH
    fp32 = dict(spec["no_dropout"], amp=False, warmup_step=10)
    hp = spec["hparams"](**fp32)
    batch = spec["batch"](gen, hp, b, text_len, mel_len, frames, "cpu")
    ref = spec["init"](hp, device="cpu")
    weights = {k: v.clone() for k, v in ref.model.state_dict().items()}
    ref, ref_logs = spec["make_step"](hp, device="cpu")(ref, batch)
    lr = ref.optimizer.schedule(0)
    counts = read_counts()
    results = {}
    for amp in (False, True):
        hp = spec["hparams"](**dict(fp32, amp=amp))
        state = spec["init"](hp, device=DEVICE)
        state.model.load_state_dict(weights)
        state, logs = spec["make_step"](hp, device=DEVICE)(state, batch)
        torch.cuda.synchronize()
        results[amp] = (state, logs)
    launched = {k: n - counts[k] for k, n in read_counts().items()}
    fwd, _, dq, dkdv = spec["kernels"]
    check(launched[fwd] > 0 and launched[dq] > 0 and launched[dkdv] > 0,
          f"{kind}: the card's step did not take {fwd}, {dq} and {dkdv}: "
          f"{launched}")
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
          f"max|ref| (tol 1e-3); card launches {json.dumps(launched)}")
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
    want.update({k: hp.n_layer_decoder for k in spec["kernels"][1:]})
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
    rate 0 (K3-f): card fp32 against the CPU's fp32 at 1e-3 of max(1,
    max|ref|) on mel_post and the stop logits, card bf16 amp at 5e-2 of
    it; each forward a path of its own, counted from 0 (6 K3-f launches,
    nothing else). Returns the bf16 forward's launches and its first
    decoder layer's kernel input, the input K3-f is timed at."""
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
        want["K3-f"] = hp.n_layer_decoder
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

    for (b, name), (ms, (_, lengths)) in sorted(results.items()):
        audio_s = lengths.sum().item() * HOP_SECONDS
        print(f"AR synthesize_transformer_tts B={b} L=128 max_steps "
              f"{MAX_AR_STEPS} bf16 amp, {name}: {ms:.3f} ms/call "
              f"({'median of 3' if name == 'graph' else 'one call'}), "
              f"{ms / MAX_AR_STEPS:.4f} ms per decode step, "
              f"{lengths.sum().item()} frames = {audio_s:.3f} s audio, RTF "
              f"{ms / 1e3 / audio_s:.6f}")
    text, pos = batches[-1]
    PROFILES.append(partial(profile_ar_synthesis, (text, pos),
                            results[text.shape[0], "graph"][0]))
    del model
    torch.cuda.empty_cache()


def profile_ar_synthesis(batch, ms_per_call):
    """``print_profile`` of one graphed ``synthesize_transformer_tts`` call
    on ``batch`` (text, positions) at AR_STOP_BIAS, after the call that
    captures its graphs."""
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_transformer_tts)
    _, model = ar_model(DEVICE, amp=True)
    with torch.no_grad():
        model.stop_token.bias.fill_(AR_STOP_BIAS)
    call = partial(synthesize_transformer_tts, model, *batch)
    call()
    print_profile(f"AR graphed synthesis B={batch[0].shape[0]}, one call",
                  call, 1, ms_per_call)


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
    """The training kernels at the train step's captured input -- K1-d,
    K2-dq and K2-dkdv, or with ``causal`` K3-d, K3-dq and K3-dkdv: kernel,
    plain and library ms, the bound, and each kernel against its fp32
    plain version there (``check_train_kernels``: O, dq, dk and dv within
    2e-2 of their own max |ref| in bf16), with the O the step's forward
    gave equal bit for bit to a second launch on the same seed. The
    library calls are SDPA with the key mask (with ``causal`` the pad-and-
    causal mask) and the same dropout rate, forward and backward (the
    backward one gives dq, dk and dv together, the yardstick of both
    backward entries). The bounds count the (row, key) pairs these inputs
    attend (``attended_pairs``)."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    fwd_id, dq_id, dkdv_id = (("K3-d", "K3-dq", "K3-dkdv") if causal
                              else ("K1-d", "K2-dq", "K2-dkdv"))
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
    errs, peaks, o_again = check_train_kernels(q, k, v, do, k_len, rate,
                                               seed, " (train step input)",
                                               causal=causal)
    check(torch.equal(o_again, o), f"{fwd_id} gave another O on the same "
                                   f"input and seed than in the train step")
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len.clamp(max=k.shape[2]), causal)
    pairs = attended_pairs(t_q, k_len.clamp(max=k.shape[2]), causal)
    el = q.element_size()
    with torch.no_grad():
        res = {fwd_id: {
            "ms": time_ms(lambda: fa.flash_attention(
                q, k, v, k_len, dropout_rate=rate, dropout_seed=seed,
                causal=causal)),
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, k_len, sm_scale, rate, seed, causal)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, dropout_p=rate, scale=sm_scale)),
            "max_abs_err": errs["o"], "max_abs_ref": peaks["o"]}}
        res[fwd_id]["bound_ms"], res[fwd_id]["bound_by"] = bound_ms(
            4 * h * pairs * d, (4 * q.numel()) * el + b * h * t_q * 4,
            q.dtype)
        rate0_ms = time_ms(lambda: fa.flash_attention(q, k, v, k_len,
                                                      causal=causal))

        delta = fa.bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, k_len)
        kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
                  causal=causal)
        in_bytes = 4 * q.numel() * el + 2 * b * h * t_q * 4   # q,k,v,dO
        res[dq_id] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
            "plain_ms": time_ms(lambda: fa.flash_attention_dq_reference(
                *args, sm_scale, rate, seed, causal)),
            "max_abs_err": errs["dq"], "max_abs_ref": peaks["dq"]}
        res[dq_id]["bound_ms"], res[dq_id]["bound_by"] = bound_ms(
            6 * h * pairs * d, in_bytes + q.numel() * el, q.dtype)
        res[dkdv_id] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
            "plain_ms": time_ms(lambda: fa.flash_attention_dkdv_reference(
                *args, sm_scale, rate, seed, causal)),
            "max_abs_err": max(errs["dk"], errs["dv"]),
            "max_abs_ref": max(peaks["dk"], peaks["dv"])}
        res[dkdv_id]["bound_ms"], res[dkdv_id]["bound_by"] = bound_ms(
            8 * h * pairs * d, in_bytes + 2 * q.numel() * el, q.dtype)
        pair_bound = bound_ms(10 * h * pairs * d, 8 * q.numel() * el,
                              q.dtype)
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, k, v))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv), do, retain_graph=True))
    res[dq_id]["library_ms"] = res[dkdv_id]["library_ms"] = library_bwd
    set_counts(counts)
    print(f"{fwd_id}/{dq_id}/{dkdv_id} vs plain at the train step's input: "
          + " ".join(f"max|d{n}|={e:.3g} (max|ref| {peaks[n]:.3g})"
                     for n, e in errs.items())
          + "; O equal to the step's")
    print(f"{fwd_id} at rate 0 on the same input: {rate0_ms:.4f} ms against "
          f"{res[fwd_id]['ms']:.4f} ms with dropout")
    print(f"{dq_id} + {dkdv_id} as a pair at that input: "
          f"{res[dq_id]['ms'] + res[dkdv_id]['ms']:.4f} ms against the "
          f"bound of the five products, {pair_bound[0]:.4f} ms "
          f"({pair_bound[1]}); SDPA backward {library_bwd:.4f} ms")
    return res


def relpos_train_kernel_timings(fwd_inputs, bwd_inputs) -> dict:
    """K4-d, K5-dq and K5-dkdv at the conformer train step's captured
    input (the first decoder layer): kernel, plain and library ms, the
    bound, and each kernel against its fp32 plain version there
    (``check_relpos_train_kernels``), with the O the step's forward gave
    equal bit for bit to a second launch on the same seed. Library: SDPA
    with the relative bias precomputed and the same dropout for K4-d;
    for K5 SDPA's backward with that bias requiring grad, plus the
    rel_shift adjoint of dbias and the two products that take it to dq_v
    and dP, each part timed, their sum the yardstick of both entries.
    Bounds per attended (row, key) pair: K4-d 6*H*d, K5 dq 10*H*d, dk/dv/dP
    12*H*d operations, against the bytes moved once."""
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
    errs, peaks, o_again = check_relpos_train_kernels(
        q_u, q_v, k, v, p, do, k_len, rate, seed, " (train step input)")
    check(torch.equal(o_again, o), "K4-d gave another O on the same input "
                                   "and seed than in the train step")
    sm_scale = q_u.shape[-1] ** -0.5
    b, h, t, d = q_u.shape
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    in_bytes = 5 * plane + p.numel() * el + 2 * b * h * t * 4
    bias = relpos_bias(q_v, p, k_len, sm_scale)
    kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed)
    with torch.no_grad():
        res = {"K4-d": {
            "ms": time_ms(lambda: fr.flash_relpos_attention(
                q_u, q_v, k, v, p, k_len, dropout_rate=rate,
                dropout_seed=seed)),
            "plain_ms": time_ms(
                lambda: fr.flash_relpos_attention_fwd_reference(
                    q_u, q_v, k, v, p, k_len, sm_scale, rate, seed)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q_u, k, v, attn_mask=bias, dropout_p=rate, scale=sm_scale)),
            "max_abs_err": errs["o"], "max_abs_ref": peaks["o"]}}
        res["K4-d"]["bound_ms"], res["K4-d"]["bound_by"] = bound_ms(
            6 * h * pairs * d, 5 * plane + p.numel() * el + b * h * t * 4,
            q_u.dtype)
        rate0_ms = time_ms(lambda: fr.flash_relpos_attention(
            q_u, q_v, k, v, p, k_len))

        args = (q_u, q_v, k, v, p, do, lse, fr.bwd_delta(o, do), k_len)
        res["K5-dq"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dq(*args,
                                                                   **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dq_reference(
                *args, sm_scale, rate, seed)),
            "max_abs_err": max(errs["dq_u"], errs["dq_v"]),
            "max_abs_ref": max(peaks["dq_u"], peaks["dq_v"])}
        res["K5-dq"]["bound_ms"], res["K5-dq"]["bound_by"] = bound_ms(
            10 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
        res["K5-dkdv"] = {
            "ms": time_ms(lambda: fr.flash_relpos_attention_bwd_dkdv(*args,
                                                                     **kw)),
            "plain_ms": time_ms(lambda: fr.flash_relpos_dkdv_reference(
                *args, sm_scale, rate, seed)),
            "max_abs_err": max(errs[n] for n in ("dk", "dv", "dp")),
            "max_abs_ref": max(peaks[n] for n in ("dk", "dv", "dp"))}
        res["K5-dkdv"]["bound_ms"], res["K5-dkdv"]["bound_by"] = bound_ms(
            12 * h * pairs * d, in_bytes + 2 * plane + p.numel() * el,
            q_u.dtype)
        pair_bound = bound_ms(16 * h * pairs * d,
                              in_bytes + 4 * plane + p.numel() * el,
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
    res["K5-dq"]["library_ms"] = res["K5-dkdv"]["library_ms"] = sum(
        parts.values())
    set_counts(counts)
    print("K4-d/K5-dq/K5-dkdv vs plain at the conformer train step's input: "
          + " ".join(f"max|d{n}|={e:.3g} (max|ref| {peaks[n]:.3g})"
                     for n, e in errs.items())
          + "; O equal to the step's")
    print(f"K4 at rate 0 on the same input: {rate0_ms:.4f} ms against "
          f"{res['K4-d']['ms']:.4f} ms with dropout")
    print(f"K5-dq + K5-dkdv as a pair at that input: "
          f"{res['K5-dq']['ms'] + res['K5-dkdv']['ms']:.4f} ms against the "
          f"bound of the pair, {pair_bound[0]:.4f} ms ({pair_bound[1]}); "
          f"library yardstick "
          + " + ".join(f"{n} {v:.4f}" for n, v in parts.items())
          + f" = {sum(parts.values()):.4f} ms")
    return res


def relpos_route(route: int, q_u, q_v, k, v, p, k_len, rate, seed):
    """The conformer's relative attention core, (o, lse): route 1 the
    relative kernels (K4/K4-d, and K5 behind autograd); route 2 the bias
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
    forward at rate 0 (1 K6) and once forward and backward at the step's
    rate (1 K6-d, 1 dq+dbias, 1 dk/dv), counted from 0, nothing else
    launched. Then each entry against its fp32 plain version at that
    input (``check_bias_kernels``), kernel, plain and library ms and the
    bound: operations per attended (row, key) pair 4*H*d forward, 6*H*d
    dq, 8*H*d dk/dv; bytes q, k, v (and dO) read once, the bias read over
    the valid keys, o (dq, or dk and dv) written once, dbias written whole.
    Library: SDPA with relpos_bias (the bias scaled and -inf-filled past
    k_len) as its mask, with the step's dropout for K6-d; for the backward
    entries SDPA's backward with the mask's gradient. Last the A/B of the
    two routes, forward and forward+backward. That the routes compute the
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
    want.update({kid: 1 for kid in bias_kernels()})
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
        errs0, peaks0, _ = check_bias_kernels(
            q_u, k, v, bias, do, k_len, 0.0, 0, " (conformer step input)")
        errs, peaks, _ = check_bias_kernels(q_u, k, v, bias, do, k_len, rate,
                                            seed, " (conformer step input)")
    pairs = attended_pairs(t, k_len, False)
    el = q_u.element_size()
    plane = q_u.numel() * el
    bias_in = h * pairs * el                # the bias over the valid keys
    stats = b * h * t * 4
    mask = relpos_bias(q_v, p, k_len, sm_scale)
    res = {}
    with torch.no_grad():
        for kid, r, e, pk in (("K6", 0.0, errs0, peaks0),
                              ("K6-d", rate, errs, peaks)):
            res[kid] = {
                "ms": time_ms(lambda: fa.flash_attention_with_bias(
                    q_u, k, v, bias, k_len, dropout_rate=r,
                    dropout_seed=seed)),
                "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
                    q_u, k, v, k_len, sm_scale, r, seed, bias=bias)),
                "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                    q_u, k, v, attn_mask=mask, dropout_p=r, scale=sm_scale)),
                "max_abs_err": e["o"], "max_abs_ref": pk["o"]}
            res[kid]["bound_ms"], res[kid]["bound_by"] = bound_ms(
                4 * h * pairs * d, 4 * plane + bias_in + stats, q_u.dtype)
        o, lse = fa.flash_attention_with_bias(q_u, k, v, bias, k_len,
                                              dropout_rate=rate,
                                              dropout_seed=seed)
        args = (q_u, k, v, do, lse, fa.bwd_delta(o, do), k_len)
        kw = dict(sm_scale=sm_scale, dropout_rate=rate, dropout_seed=seed,
                  bias=bias)
        in_bytes = 4 * plane + 2 * stats + bias_in
        res["K6-dq"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dq(*args, **kw)),
            "plain_ms": time_ms(lambda: fa.flash_attention_dq_reference(
                *args, sm_scale, rate, seed, bias=bias)),
            "max_abs_err": max(errs["dq"], errs["dbias"]),
            "max_abs_ref": max(peaks["dq"], peaks["dbias"])}
        res["K6-dq"]["bound_ms"], res["K6-dq"]["bound_by"] = bound_ms(
            6 * h * pairs * d, in_bytes + plane + bias.numel() * el,
            q_u.dtype)
        res["K6-dkdv"] = {
            "ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(*args, **kw)),
            "plain_ms": time_ms(lambda: fa.flash_attention_dkdv_reference(
                *args, sm_scale, rate, seed, bias=bias)),
            "max_abs_err": max(errs["dk"], errs["dv"]),
            "max_abs_ref": max(peaks["dk"], peaks["dv"])}
        res["K6-dkdv"]["bound_ms"], res["K6-dkdv"]["bound_by"] = bound_ms(
            8 * h * pairs * d, in_bytes + 2 * plane, q_u.dtype)
    lq, lk, lv, lmask = (x.detach().clone().requires_grad_()
                         for x in (q_u, k, v, mask))
    lo = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=lmask,
                                        dropout_p=rate, scale=sm_scale)
    library_bwd = time_ms(lambda: torch.autograd.grad(
        lo, (lq, lk, lv, lmask), do, retain_graph=True))
    res["K6-dq"]["library_ms"] = res["K6-dkdv"]["library_ms"] = library_bwd

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
    for r, e, pk in ((0.0, errs0, peaks0), (rate, errs, peaks)):
        print(f"K6 vs plain at the conformer train step's input, bias "
              f"rel_shift(q_v P^T) {str(q_u.dtype)[6:]}, rate {r}: "
              + " ".join(f"max|d{n}|={x:.3g} (max|ref| {pk[n]:.3g})"
                         for n, x in e.items()))
    print("conformer routes at that input, each difference a share of "
          "route 1's fp32 max|ref|: route 2 against route 1 in fp32 (tol "
          "2e-2); route 1 and route 2 in bf16 against route 1 in fp32: "
          + ", ".join(f"{n} {a:.2e} | {b1:.2e} {b2:.2e}"
                      for n, (a, b1, b2) in agree.items()))
    print("conformer route A/B (route 1: K4-d, K5 behind autograd; route "
          "2: the bias in device memory, K6-d, K6's backward, the "
          "rel_shift adjoint and the products by autograd), dropout "
          f"{rate}: " + ", ".join(f"{n} {v:.4f} ms" for n, v in ab.items()))
    print(f"K6 backward as a pair at that input: "
          f"{res['K6-dq']['ms'] + res['K6-dkdv']['ms']:.4f} ms; SDPA "
          f"backward with the mask's gradient {library_bwd:.4f} ms")
    return res, launches


def relpos_route_bias(q_v, p):
    """Route 2's bias: rel_shift(q_v P^T), unscaled and unmasked, in q_v's
    dtype, contiguous (K6's input)."""
    from transformer_tts_tpu_torch.ops.flash_relpos import rel_shift
    return rel_shift(torch.matmul(q_v, p.transpose(-1, -2))).contiguous()


def causal_forward_timings(inputs) -> dict:
    """K3-f at its path's captured input (the first decoder layer of the
    teacher-forced eval forward): kernel, plain and library (SDPA with
    the pad-and-causal mask) ms, the bound over the attended pairs, and
    O's error against the fp32 plain version on the same inputs."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops import flash_attention as fa
    (q, k, v, k_len), kw = inputs
    check(kw.get("causal") is True and kw.get("dropout_rate", 0.0) == 0.0,
          "the captured eval forward is not K3-f's")
    counts = read_counts()
    sm_scale = q.shape[-1] ** -0.5
    b, h, t_q, d = q.shape
    mask = sdpa_mask(t_q, k.shape[2], k_len, True)
    with torch.no_grad():
        o, _ = fa.flash_attention(q, k, v, k_len, causal=True)
        ro, _ = fa.flash_attention_fwd_reference(
            *(x.float() for x in (q, k, v)), k_len, sm_scale, causal=True)
        err, peak = max_err(o, ro)
        check(err <= REL_TOL[q.dtype] * peak,
              f"K3-f at its path's input: {err} against max|ref| {peak}")
        res = {
            "ms": time_ms(lambda: fa.flash_attention(q, k, v, k_len,
                                                     causal=True)),
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_reference(
                q, k, v, k_len, sm_scale, causal=True)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, scale=sm_scale)),
            "max_abs_err": err, "max_abs_ref": peak}
    res["bound_ms"], res["bound_by"] = bound_ms(
        4 * h * attended_pairs(t_q, k_len, True) * d,
        4 * q.numel() * q.element_size() + b * h * t_q * 4, q.dtype)
    set_counts(counts)
    return res


# ---- phase 8: attention paths -----------------------------------------------

def phase_attention_paths(gen):
    from transformer_tts_tpu_torch.ops import attention
    from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
    from transformer_tts_tpu_torch.ops.flash_relpos import (
        flash_relpos_attention)
    launches = flash_attention.launches, flash_relpos_attention.launches
    for t in (128, 256, 768, 2048):
        q_u, q_v, k, v, p = (x.to(torch.bfloat16) for x in
                             kernel_inputs("K4", gen, 8, 4, t, t, 96))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        times = [
            time_ms(lambda: flash_attention(q_u, k, v, k_len)),
            time_ms(lambda: attention.scaled_dot_attention(q_u, k, v, mask)),
            time_ms(lambda: flash_relpos_attention(q_u, q_v, k, v, p,
                                                   k_len)),
            time_ms(lambda: attention.relative_dot_attention(
                q_u, q_v, k, v, p[None], mask))]
        print(f"attention B=8 H=4 d=96 bf16 T={t}: K1 path {times[0]:.4f} "
              f"ms, masked-fill path {times[1]:.4f} ms; K4 path "
              f"{times[2]:.4f} ms, relative masked-fill path "
              f"{times[3]:.4f} ms")
    flash_attention.launches, flash_relpos_attention.launches = launches


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
                   | {"flash_attention_bwd", "flash_relpos_bwd"})
    with phase("build"):
        cuda_build.build(names)
    for name in names:
        for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "Used" in line or "spill" in line:
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
    with phase("K4-d and K5 vs plain"):
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
        for kid, (launches, main_inputs) in main_runs.items():
            tensors, k_len = list(main_inputs[:-1]), main_inputs[-1]
            res = kernel_timings(kid, tensors, k_len)
            print(f"{kid} at the main path's input "
                  f"{tuple(tensors[0].shape)} {str(tensors[0].dtype)[6:]}, "
                  f"k_len {k_len.tolist()}: kernel {res['ms']:.4f} ms, "
                  f"plain {res['plain_ms']:.4f} ms, library "
                  f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} "
                  f"ms ({res['bound_by']}), max|dO| {res['max_abs_err']:.3g}")
            if "bias_ms" in res:
                print(f"{kid} library yardstick leaves out building its "
                      f"bias: {res['bias_ms']:.4f} ms")
            _, _, name, source, replaces = registry[kid]
            lines.append(kernels_line_entry(name, source, replaces,
                                            launches, res))
        runs = {}                 # id -> (result, launches, its input)
        for kid, res in train_kernel_timings(fwd_inputs,
                                             bwd_inputs).items():
            runs[kid] = (res, train_launches[kid], fwd_inputs)
        for kid, res in train_kernel_timings(ar_fwd_inputs, ar_bwd_inputs,
                                             causal=True).items():
            runs[kid] = (res, ar_launches[kid], ar_fwd_inputs)
        runs["K3-f"] = (causal_forward_timings(k3f_inputs),
                        k3f_launches["K3-f"], k3f_inputs)
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
                  f"{res['max_abs_ref']:.3g}), launches {launches}")
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
                  f"{res['max_abs_ref']:.3g}), launches in the route A/B "
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
