"""Checkpoint averaging CLI of the PyTorch port (the port of
transformer_tts_tpu/cli/average_checkpoints.py).

``python -m transformer_tts_tpu_torch.cli.average_checkpoints
      --save_dir DIR [--start_epoch A] [--end_epoch B] [--last N]
      [--hp_file h.py]``

Averages the ``state_dict``s of the saved epochs in [A, B] (default: the
first and the newest) or of the newest N (``--last``) into
``DIR/average_epoch{A}-epoch{B}/`` (``train/checkpoint.average_checkpoints``):
``model.pt`` and ``hparams.py`` (``--hp_file``, default the newest epoch's),
so the directory is a synthesis ``--load_name``. Runs on the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--hp_file", type=str, default=None)
    parser.add_argument("--start_epoch", type=int, default=None)
    parser.add_argument("--end_epoch", type=int, default=None)
    parser.add_argument("--last", type=int, default=None)
    args = parser.parse_args(argv)

    from transformer_tts_tpu_torch.train import checkpoint as ckpt

    epochs = ckpt.list_epochs(args.save_dir)
    if not epochs:
        raise SystemExit(f"no checkpoints under {args.save_dir}")
    if args.last is not None:
        chosen = epochs[-args.last:]
        start, end = chosen[0], chosen[-1]
    else:
        start = args.start_epoch if args.start_epoch is not None \
            else epochs[0]
        end = args.end_epoch if args.end_epoch is not None else epochs[-1]
    _, out_path = ckpt.average_checkpoints(args.save_dir, start, end,
                                           hp_file=args.hp_file)
    print(f"averaged epochs [{start}, {end}] -> {out_path}")


if __name__ == "__main__":
    main()
