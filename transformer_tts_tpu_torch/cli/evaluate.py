"""Evaluation CLI of the PyTorch port (the port of
transformer_tts_tpu/cli/evaluate.py:23-79): mel-L1 and MCD between
generated and reference mels.

``python -m transformer_tts_tpu_torch.cli.evaluate --ref_script test.txt
      --gen_dir generated/ [--n_mfc 13] [--dtw]``

Pairs each ``<idx>.npy`` in ``--gen_dir`` (the synthesis CLI's output
naming) with line ``idx`` of the reference script (``mel_path|text``,
the mels de-normalised ground truth), and prints per-utterance and mean
mel-L1 and MCD. ``--pairs REF GEN`` compares two .npy files instead.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_script", type=str, default=None,
                        help="mel_path|text lines (ground-truth mels)")
    parser.add_argument("--gen_dir", type=str, default=None,
                        help="synthesize CLI output dir (<idx>.npy)")
    parser.add_argument("--pairs", nargs=2, metavar=("REF", "GEN"),
                        default=None, help="compare two .npy files")
    parser.add_argument("--n_mfc", type=int, default=13)
    parser.add_argument("--dtw", action="store_true",
                        help="force DTW alignment (auto when lengths "
                             "differ)")
    args = parser.parse_args(argv)

    from transformer_tts_tpu_torch.eval import mcd, mel_l1

    use_dtw = True if args.dtw else None
    pairs = []
    if args.pairs:
        pairs.append(("pair", args.pairs[0], args.pairs[1]))
    else:
        if not (args.ref_script and args.gen_dir):
            parser.error("need --ref_script + --gen_dir, or --pairs")
        with open(args.ref_script) as fh:
            lines = [ln.strip() for ln in fh if ln.strip()]
        for idx, line in enumerate(lines):
            gen = os.path.join(args.gen_dir, f"{idx}.npy")
            if os.path.exists(gen):
                pairs.append((str(idx), line.split("|")[0], gen))

    if not pairs:
        print("no (ref, gen) pairs found", file=sys.stderr)
        return 1

    l1s, mcds = [], []
    for name, ref_path, gen_path in pairs:
        ref = np.load(ref_path).astype(np.float32)
        gen = np.load(gen_path).astype(np.float32)
        if ref.ndim == 1:
            ref = ref[:, None]
        if gen.ndim == 1:
            gen = gen[:, None]
        d = min(ref.shape[1], gen.shape[1])
        l1 = mel_l1(ref[:, :d], gen[:, :d])
        m = mcd(ref[:, :d], gen[:, :d], n_mfc=min(args.n_mfc, d - 1),
                use_dtw=use_dtw)
        l1s.append(l1)
        mcds.append(m)
        print(f"{name}: frames ref={ref.shape[0]} gen={gen.shape[0]} "
              f"mel_l1={l1:.4f} mcd={m:.3f} dB")
    print(f"mean over {len(pairs)}: mel_l1={np.mean(l1s):.4f} "
          f"mcd={np.mean(mcds):.3f} dB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
