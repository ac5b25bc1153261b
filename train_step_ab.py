"""Train-step times of checkouts of this repo on one CUDA card, for
comparing two commits in one call.

    python3 train_step_ab.py PARENT_DIR . . PARENT_DIR

Each directory (a checkout's root, e.g. a ``git archive`` of the parent
commit unpacked under the gitignored ``build/``) runs in a process of its
own, in the order given: it builds that checkout's kernels, then times the
three flagship train steps of its ``chip_smoke.py`` (the transformer
FastSpeech 2, the conformer and the AR Transformer-TTS, at chip_smoke's
batch: bf16 amp, dropout 0.1; 3 warm-up steps, then the median of 10 by
CUDA events), runs one ``torch.profiler`` pass (CPU and CUDA activity)
over 3 FastSpeech 2 steps, and times the three steps again: whether a
profiler pass slows the rest of its process. Each process prints one line
``AB {json}``; the card's name and power limit come first.
"""

import json
import os
import statistics
import subprocess
import sys


def measure(root: str) -> dict:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from transformer_tts_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build(["flash_attention_fwd", "flash_attention_bwd",
                      "flash_relpos_fwd", "flash_relpos_bwd"])
    gen = torch.Generator().manual_seed(0)
    b, text_len, mel_len, frames = cs.TRAIN_BATCH
    fs2 = cs.train_batch(gen, cs.train_hparams(), b, text_len, mel_len,
                         frames, "cuda")
    batches = {"fastspeech2": fs2, "conformer": fs2,
               "ar": cs.ar_train_batch(gen, cs.ar_hparams(), b, text_len,
                                       mel_len, frames, "cuda")}
    runs = {}
    for kind in batches:
        spec = cs.trainer(kind)
        hp = spec["hparams"]()
        runs[kind] = [spec["init"](hp, device="cuda"),
                      spec["make_step"](hp, device="cuda")]

    def step_ms(kind, n=10, warmup=3):
        state, step = runs[kind]
        for _ in range(warmup):
            state, _ = step(state, batches[kind])
        events = []
        for _ in range(n):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            state, _ = step(state, batches[kind])
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        runs[kind][0] = state
        return statistics.median(s.elapsed_time(e) for s, e in events)

    out = {"root": root, "before": {k: step_ms(k) for k in runs}}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_ms("fastspeech2", n=3, warmup=0)
    out["profiled_fastspeech2_device_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()) / 1e3 / 3
    out["after"] = {k: step_ms(k) for k in runs}
    return out


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print("AB " + json.dumps(measure(sys.argv[2])), flush=True)
        return
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    me = os.path.abspath(__file__)
    failed = 0
    for root in sys.argv[1:]:
        failed |= subprocess.run([sys.executable, me, "--one", root]
                                 ).returncode
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
