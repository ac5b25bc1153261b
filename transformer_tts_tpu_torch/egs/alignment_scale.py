"""Not ported yet: the duration-extraction accuracy study on a corpus the
teacher cannot memorize, egs/alignment_scale/run.py of the JAX package.
It stands in ROADMAP.md, Queue 1; until then this entry point raises.

    python -m transformer_tts_tpu_torch.egs.alignment_scale
"""

from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "egs/alignment_scale/run.py is not ported yet: ROADMAP.md, Queue 1")


if __name__ == "__main__":
    main()
