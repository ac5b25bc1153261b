"""Script files for synthesis (the port of ``parse_script`` and the
test-mode part of ``TTSDataset``, transformer_tts_tpu/data/dataset.py).

Script format: ``mel_path|text_ids[|...]`` per line, pipe-separated, with
space-separated integer ids. SentencePiece text and the training-time
targets (alignment, f0, energy, speakers) come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def parse_script(path: str) -> List[List[str]]:
    rows = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line:
                rows.append(line.split("|"))
    return rows


def encode_text(text: str) -> np.ndarray:
    return np.asarray([int(t) for t in text.split(" ")], np.int32)


class ScriptDataset:
    """The utterances of a script, as {mel_name, text, text_length}."""

    def __init__(self, script_path: str, hp):
        if hp.spm_model is not None:
            raise NotImplementedError(
                "SentencePiece text comes with a later slice of the port; "
                "give space-separated ids")
        self.rows = parse_script(script_path)

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.rows[idx]
        text = encode_text(row[1].strip())
        return {"mel_name": row[0], "text": text, "text_length": len(text)}
