"""Not ported yet: the multi-speaker demonstration (synthesis follows the
speaker label, speaker ids and x-vectors), egs/multi_speaker/run.py of
the JAX package. It stands in ROADMAP.md, Queue 1; until then this entry
point raises.

    python -m transformer_tts_tpu_torch.egs.multi_speaker
"""

from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "egs/multi_speaker/run.py is not ported yet: ROADMAP.md, Queue 1")


if __name__ == "__main__":
    main()
