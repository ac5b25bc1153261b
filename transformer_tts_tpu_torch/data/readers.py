"""Per-corpus mel statistics (the port of ``Normalizer``,
transformer_tts_tpu/data/readers.py:46-73, as far as synthesis needs it:
the mean/var arrays that ``infer/synthesize.denormalize`` applies).
Normalizing training mels comes with the training slice."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


class Normalizer:
    def __init__(self, mean_file: Optional[str], var_file: Optional[str],
                 mel_dim: int):
        if mean_file is not None and var_file is not None:
            self.mean = np.load(mean_file).reshape(-1, mel_dim)
            self.var = np.load(var_file).reshape(-1, mel_dim)
        else:
            self.mean = self.var = None

    def arrays(self) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        return self.mean, self.var
