"""Print a single hparam value (the port of transformer_tts_tpu/cli/
parse_hparams.py, itself the reference's tools/parse_hparams.py:1-15).

``python -m transformer_tts_tpu_torch.cli.parse_hparams --hp_file h.py
      --key x``
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--hp_file", type=str, required=True)
    parser.add_argument("--key", type=str, required=True)
    args = parser.parse_args(argv)
    from transformer_tts_tpu_torch.config import load_hparams
    hp = load_hparams(args.hp_file)
    print(getattr(hp, args.key))


if __name__ == "__main__":
    main()
