#!/usr/bin/env python3
"""Drive the PyTorch port's FastSpeech 2 synthesis on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernel) and ``nvcc``; exits
non-zero, printing no result, without them. Phases, each fatal on failure:

1. device: the card's name and power limit (nvidia-smi);
2. build: every kernel of the path from the sources in the checkout;
3. K1 (csrc/flash_attention_fwd.cu) against its plain PyTorch version on
   the card: fp32 at 1e-4 on O and lse (TF32 off), bf16 against the plain
   version in fp32 on the same bf16 inputs at 2e-2 on O and 1e-3 on lse,
   rows with no valid key exactly 0; kernel, plain and SDPA times;
4. the flagship FastSpeech 2 (d 384, 6+6 layers, 4 heads of 96, random
   weights from seed 0):
   (a) teacher-forced forward, card fp32 (kernel path) against the CPU
       fp32 at 1e-3 max abs on mel_post, and card bf16 amp against the CPU
       fp32 at 5e-2 * max(1, max|ref|) (bf16 keeps ~3 significant digits
       through 12 layers and the postnet);
   (b) synthesize_fastspeech2 with predicted durations at B=1 / 768 frames
       and B=8 / 2048 frames: the main path, whose kernel launches are
       counted (6 per call, one per decoder layer), with ms and RTF;
   (c) the synthesis CLI as a subprocess on a 3-line script;
5. attention-path timing, kernel against masked-fill, at T in
   {128, 256, 768, 2048}.

It then prints the kernels line (JSON), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
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


def attention_bound_ms(q, k, v, k_len) -> tuple:
    """Least time for the kernel's work on these inputs: the larger of
    its operations over the peak rate and its bytes over HBM's rate."""
    b, h, t_q, d = q.shape
    keys = k_len.clamp(max=k.shape[2]).double().sum().item()
    flops = 4.0 * h * t_q * keys * d
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) \
        * q.element_size() + b * h * t_q * 4 + k_len.numel() * 4
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


# ---- phase 3: K1 against its plain version ----------------------------------

def k1_errors(q, k, v, k_len):
    """(err_o, err_lse) of the kernel against the fp32 plain version on the
    same inputs; fails unless rows with no valid key are exactly 0."""
    from transformer_tts_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_fwd_reference)
    sm_scale = q.shape[-1] ** -0.5
    o, lse = flash_attention(q, k, v, k_len, sm_scale=sm_scale)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_fwd_reference(q.float(), k.float(), v.float(),
                                             k_len, sm_scale)
    empty = (k_len == 0)
    check(bool((o[empty] == 0).all()) and
          bool((lse[empty] == np.float32(NEG_INF)).all()),
          "K1: rows with no valid key are not exactly 0 / -1e30")
    valid = ~empty
    err_o = (o.float() - ro)[valid].abs().max().item()
    err_lse = (lse - rlse)[valid].abs().max().item()
    return err_o, err_lse


def phase_kernel_vs_plain(gen):
    cases = [  # (B, H, T_q, T_k, d, k_len)
        (1, 4, 768, 768, 96, [768]),
        (8, 4, 2048, 2048, 96, [2048, 0, 1000, 1, 2047, 64, 65, 1500]),
        (2, 4, 1000, 1000, 96, [1000, 333]),                  # ragged T
        (2, 4, 300, 700, 96, [700, 0]),                       # T_q != T_k
    ]
    tols = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}
    for b, h, t_q, t_k, d, k_len in cases:
        q = torch.randn(b, h, t_q, d, generator=gen).to(DEVICE)
        k = torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
        v = torch.randn(b, h, t_k, d, generator=gen).to(DEVICE)
        kl = torch.tensor(k_len, dtype=torch.int32, device=DEVICE)
        for dtype, (tol_o, tol_lse) in tols.items():
            err_o, err_lse = k1_errors(q.to(dtype), k.to(dtype),
                                       v.to(dtype), kl)
            print(f"K1 vs plain ({b},{h},{t_q},{t_k},{d}) "
                  f"{str(dtype)[6:]} k_len={k_len}: max|dO|={err_o:.3g} "
                  f"(tol {tol_o}) max|dlse|={err_lse:.3g} (tol {tol_lse})")
            check(err_o <= tol_o and err_lse <= tol_lse,
                  f"K1 disagrees with its plain version at {(b, h, t_q, d)} "
                  f"{dtype}")
    for b, t in ((1, 768), (8, 2048)):      # the synthesis shapes, all keys
        q, k, v = (torch.randn(b, 4, t, 96, generator=gen).to(DEVICE)
                   .to(torch.bfloat16) for _ in range(3))
        res = kernel_timings(q, k, v, torch.full(
            (b,), t, dtype=torch.int32, device=DEVICE))
        print(f"K1 ({b},4,{t},96) bf16 all keys: kernel {res['ms']:.4f} ms, "
              f"plain {res['plain_ms']:.4f} ms, SDPA "
              f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
              f"({res['bound_by']})")


def kernel_timings(q, k, v, k_len) -> dict:
    """Kernel, plain version and SDPA times on the same inputs, the bound
    and the kernel's error against the fp32 plain version."""
    import torch.nn.functional as F
    from transformer_tts_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_fwd_reference)
    sm_scale = q.shape[-1] ** -0.5
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < k_len[:, None])[:, None, None, :]
    launches = flash_attention.launches
    res = {
        "ms": time_ms(lambda: flash_attention(q, k, v, k_len,
                                              sm_scale=sm_scale)),
        "plain_ms": time_ms(lambda: flash_attention_fwd_reference(
            q, k, v, k_len, sm_scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=sm_scale)),
    }
    res["bound_ms"], res["bound_by"] = attention_bound_ms(q, k, v, k_len)
    res["max_abs_err"] = k1_errors(q, k, v, k_len)[0]
    # these launches are not launches of the main path
    flash_attention.launches = launches
    return res


# ---- phase 4: the full-width slice ------------------------------------------

def flagship_model(device, amp: bool, seed: int = 0):
    from transformer_tts_tpu_torch.config import HParams
    from transformer_tts_tpu_torch.models.fastspeech2 import (
        build_fastspeech2)
    # d 384, 6+6 layers, 4 heads, vocab 152, mel 80
    hp = HParams(**dict(FLAGSHIP, amp=amp))
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


def phase_teacher_forced(gen):
    from transformer_tts_tpu_torch.ops.masks import pad_mask
    hp, cpu_model = flagship_model("cpu", amp=False)
    text, pos = text_batch(gen, 2, 128, 100, hp.vocab_size)
    t = 768
    d = torch.randint(2, 8, text.shape, generator=gen) * (text != 0)
    p = torch.rand(2, t, generator=gen) * 740 + 60
    e = torch.rand(2, t, generator=gen) * 315
    inputs = (text, pad_mask(pos), t, d, p, e)

    with torch.no_grad():
        ref = cpu_model(*inputs)
    _, model = flagship_model(DEVICE, amp=False)
    cuda_inputs = [x.to(DEVICE) if torch.is_tensor(x) else x for x in inputs]
    results = {}
    for amp in (False, True):
        model.amp = amp
        with torch.no_grad():
            out = model(*cuda_inputs)
        check(torch.equal(out.mel_len.cpu(), ref.mel_len),
              "teacher-forced mel_len differs between card and CPU")
        errs = []
        for b, n in enumerate(ref.mel_len.tolist()):
            diff = out.mel_post[b, :n].float().cpu() - ref.mel_post[b, :n]
            errs.append(diff.abs().max().item())
        peak = ref.mel_post.abs().max().item()
        tol = 5e-2 * max(1.0, peak) if amp else 1e-3
        name = "bf16 amp" if amp else "fp32"
        print(f"teacher-forced forward B=2 L=128 T={t}: card {name} vs CPU "
              f"fp32: max|d mel_post| = {max(errs):.3g} (tol {tol:.3g}, "
              f"max|ref| = {peak:.3g}, frames {ref.mel_len.tolist()})")
        check(max(errs) <= tol, f"card {name} forward disagrees with CPU")
        results[name] = max(errs)
    return results


@contextmanager
def capture_kernel_inputs(store: list):
    """Keep a copy of the first flash_attention call's inputs per call of
    the main path; launches still count in the real function."""
    from transformer_tts_tpu_torch.ops import attention
    real = attention.flash_attention

    def recording(q, k, v, k_len, **kw):
        if len(store) < 1:
            store.append((q.clone(), k.clone(), v.clone(), k_len.clone()))
        return real(q, k, v, k_len, **kw)

    attention.flash_attention = recording
    try:
        yield
    finally:
        attention.flash_attention = real


def phase_synthesis(gen):
    from transformer_tts_tpu_torch.infer.synthesize import (
        synthesize_fastspeech2)
    from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
    hp, model = flagship_model(DEVICE, amp=True)
    cases = [(1, 768), (8, 2048)]
    batches = []
    for batch, max_frames in cases:
        text, pos = text_batch(gen, batch, 128, 48, hp.vocab_size)
        batches.append((text.to(DEVICE), pos.to(DEVICE), max_frames))

    captured = []
    flash_attention.launches = 0            # the main path starts here
    per_call = []
    with capture_kernel_inputs(captured):
        for text, pos, max_frames in batches:
            captured.clear()
            before = flash_attention.launches
            mel, mel_len, dur = synthesize_fastspeech2(model, text, pos,
                                                       max_frames)
            torch.cuda.synchronize()
            per_call.append(flash_attention.launches - before)
            check(mel.shape == (text.shape[0], max_frames, hp.mel_dim),
                  f"mel shape {tuple(mel.shape)}")
            check(bool(torch.isfinite(mel.float()).all()), "non-finite mel")
            check(int(mel_len.min()) > 0, "empty mel_len")
    launches = flash_attention.launches     # the main path ends here
    print(f"main path: K1 launches per synthesis call {per_call} "
          f"(expect {hp.n_layer_decoder} each), total {launches}")
    check(all(n == hp.n_layer_decoder for n in per_call),
          "K1 did not launch once per decoder layer")
    main_inputs = captured[0]               # the B=8 / 2048-frame call

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
        print(f"synthesize_fastspeech2 B={text.shape[0]} L=128 "
              f"max_frames={max_frames} bf16 amp: {ms:.3f} ms/call "
              f"(median of 10), {mel_len.sum().item()} frames = "
              f"{audio_s:.3f} s audio, RTF {rtf:.6f}")
    flash_attention.launches = launches
    return hp, model, launches, main_inputs


def phase_cli(hp, model):
    from transformer_tts_tpu_torch.train.checkpoint import save_checkpoint
    model_dir = os.path.join(WORK, "model")
    out_dir = os.path.join(WORK, "generated")
    os.makedirs(model_dir, exist_ok=True)
    save_checkpoint(model, model_dir)
    script = os.path.join(WORK, "test.txt")
    rs = np.random.RandomState(0)
    lines = [" ".join(str(i) for i in rs.randint(1, hp.vocab_size, n))
             for n in (40, 90, 128)]
    with open(script, "w") as fh:
        fh.write("".join(f"utt{i}.npy|{s}\n" for i, s in enumerate(lines)))
    with open(os.path.join(model_dir, "hparams.py"), "w") as fh:
        for key, value in dict(FLAGSHIP, test_script=script).items():
            fh.write(f"{key} = {value!r}\n")
    proc = subprocess.run(
        [sys.executable, "-m", "transformer_tts_tpu_torch.cli.synthesize",
         "--load_name", model_dir, "--save", out_dir, "--max_frames",
         "2048", "--device", DEVICE], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    print(proc.stdout.strip())
    check(proc.returncode == 0, f"CLI exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    for i, n_text in enumerate((40, 90, 128)):
        mel = np.load(os.path.join(out_dir, f"{i}.npy"))
        align = np.load(os.path.join(out_dir, f"{i}_alignment.npy"))
        check(mel.dtype == np.float32 and mel.ndim == 2
              and mel.shape[1] == hp.mel_dim
              and 0 < mel.shape[0] <= 2048
              and bool(np.isfinite(mel).all()), f"CLI mel {i} {mel.shape}")
        check(mel.shape[0] == min(2048, int(align.sum()))
              and align.shape[0] >= n_text, f"CLI alignment {i}")
    print("CLI: 3 utterances written and checked")


# ---- phase 5: attention paths -------------------------------------------------

def phase_attention_paths(gen):
    from transformer_tts_tpu_torch.ops.attention import scaled_dot_attention
    from transformer_tts_tpu_torch.ops.flash_attention import flash_attention
    launches = flash_attention.launches
    for t in (128, 256, 768, 2048):
        q, k, v = (torch.randn(8, 4, t, 96, generator=gen).to(DEVICE)
                   .to(torch.bfloat16) for _ in range(3))
        k_len = torch.full((8,), t, dtype=torch.int32, device=DEVICE)
        mask = torch.ones(8, 1, t, dtype=torch.bool, device=DEVICE)
        kernel = time_ms(lambda: flash_attention(q, k, v, k_len))
        masked = time_ms(lambda: scaled_dot_attention(q, k, v, mask))
        print(f"attention B=8 H=4 d=96 bf16 T={t}: kernel path "
              f"{kernel:.4f} ms, masked-fill path {masked:.4f} ms")
    flash_attention.launches = launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    from transformer_tts_tpu_torch.ops import cuda_build
    from transformer_tts_tpu_torch.ops.flash_attention import KERNEL

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.time()
    cuda_build.build([KERNEL])
    print(f"build: {time.time() - t0:.1f} s")
    for line in cuda_build.BUILD_LOGS.get(KERNEL, "").splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip())

    gen = torch.Generator().manual_seed(0)
    phase_kernel_vs_plain(gen)
    phase_teacher_forced(gen)
    hp, model, launches, main_inputs = phase_synthesis(gen)
    phase_cli(hp, model)

    shape = tuple(main_inputs[0].shape)
    res = kernel_timings(*main_inputs)
    print(f"K1 at the main path's input {shape} bf16, k_len "
          f"{main_inputs[3].tolist()}: kernel {res['ms']:.4f} ms, plain "
          f"{res['plain_ms']:.4f} ms, SDPA {res['library_ms']:.4f} ms, "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
    phase_attention_paths(gen)

    kernels = [{
        "name": KERNEL, "route": "cuda",
        "source": "transformer_tts_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "transformer_tts_tpu/ops/flash_attention.py:90",
        "launches": launches, "max_abs_err": res["max_abs_err"],
        "ms": res["ms"], "plain_ms": res["plain_ms"],
        "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
        "library_ms": res["library_ms"]}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
