"""Not ported yet: the GST style-transfer demonstration (the style of
synthesis follows the reference mel's), egs/gst_style/run.py of the JAX
package. It stands in ROADMAP.md, Queue 1; until then this entry point
raises.

    python -m transformer_tts_tpu_torch.egs.gst_style
"""

from __future__ import annotations


def main(argv=None):
    raise NotImplementedError(
        "egs/gst_style/run.py is not ported yet: ROADMAP.md, Queue 1")


if __name__ == "__main__":
    main()
