"""Serving CLI of the PyTorch port (the port of
transformer_tts_tpu/cli/serve.py): a warmed-up bucketed engine behind the
micro-batching HTTP server.

``python -m transformer_tts_tpu_torch.cli.serve --load_name DIR
      [--port 8571] [--batch_size 8] [--buckets 32,64,128]
      [--vocoder GEN_DIR] [--quantize int8] [--ref_mel r.npy]
      [--device cuda]``

``DIR`` resolves as in the synthesis CLI (infer/engine.py). It warms every
(batch, bucket) shape, prints each bucket's seconds, then serves ``POST
/synthesize``, ``POST /synthesize_stream``, ``GET /healthz`` and ``GET
/metrics`` (infer/server.py) until SIGINT, which stops it with exit code
0. ``--port 0`` binds a free port; the "serving on" line names the port
bound. ``--quantize int8`` prints the quantization's stats line.
``--export DIR`` writes the engine's ``torch.export`` artifacts and
``manifest.json`` into ``DIR`` (``TTSEngine.export``), prints the
manifest and exits, as the JAX CLI does. ``--post_model`` comes with a
later slice and raises. It runs on the CUDA device unless ``--device
cpu`` is given, and raises when that device is missing.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--load_name", type=str, required=True)
    parser.add_argument("--hp_file", type=str, default=None)
    parser.add_argument("--epoch", type=int, default=None)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8571)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--frames_per_phone", type=int, default=8)
    parser.add_argument("--buckets", type=str, default=None,
                        help="comma-separated text buckets "
                             "(default: hp.text_buckets)")
    parser.add_argument("--batch_window_ms", type=float, default=5.0)
    parser.add_argument("--max_queue", type=int, default=256,
                        help="admission bound; past it requests get 503 "
                             "instead of unbounded queueing")
    parser.add_argument("--export", type=str, default=None,
                        help="write torch.export artifacts and "
                             "manifest.json into this directory, then "
                             "exit")
    parser.add_argument("--vocoder", type=str, default=None,
                        help="generator export or vocoder_<k> dir of "
                             "cli.train_vocoder; wav responses use it "
                             "instead of Griffin-Lim")
    parser.add_argument("--quantize", type=str, default=None,
                        choices=("int8",),
                        help="weight-only int8 of the acoustic model "
                             "(infer/quantize.py)")
    parser.add_argument("--post_model", type=str, default=None)
    parser.add_argument("--ref_mel", type=str, default=None,
                        help="style reference mel .npy for GST models "
                             "(required when hp.gst)")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    from transformer_tts_tpu_torch.infer.engine import TTSEngine
    from transformer_tts_tpu_torch.infer.server import TTSServer

    buckets = None
    if args.buckets:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = TTSEngine(
        args.load_name, args.hp_file, epoch=args.epoch,
        batch_size=args.batch_size, frames_per_phone=args.frames_per_phone,
        text_buckets=buckets, vocoder=args.vocoder,
        quantize=args.quantize, post_model=args.post_model,
        ref_mel=args.ref_mel, device=args.device)
    if engine.quantize_stats is not None:
        s = engine.quantize_stats
        print(f"int8 weights: {s['n_quantized']} tensors quantized "
              f"(an int8 copy would take {s['bytes_q'] / 1e6:.1f} MB "
              f"against {s['bytes_fp'] / 1e6:.1f} MB); served as q * s "
              "in the fp32 parameters, so the card holds as many weight "
              "bytes as without --quantize", flush=True)

    if args.export:
        print(json.dumps(engine.export(args.export), indent=2))
        return

    print("warming up (every batch and bucket shape once)...", flush=True)
    for b, s in engine.warmup().items():
        print(f"  bucket {b:4d}: {s:6.1f} s "
              f"(max_frames {engine.max_frames_for(b)})", flush=True)

    server = TTSServer(engine, host=args.host, port=args.port,
                       batch_window_ms=args.batch_window_ms,
                       max_queue=args.max_queue)
    print(f"serving on http://{args.host}:{server.port}  "
          f"(batch {engine.batch_size}, buckets {engine.text_buckets})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    sys.exit(main())
