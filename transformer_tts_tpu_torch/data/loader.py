"""Training batches (the port of ``DataLoader``,
transformer_tts_tpu/data/loader.py:22-99, as a plain synchronous loader).

The sampler comes from the hparams: ``batch_size`` gives a
``NumBatchSampler``, ``max_seqlen`` a frame-budget ``LengthsBatchSampler``
over the mel lengths; each batch is loaded and collated to bucket shapes
with power-of-two batch padding. The JAX package's thread-pool prefetch,
native mel reader (``data/native.py``) and host sharding are left out
(the slice "parallelism and remaining tools").
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from transformer_tts_tpu_torch.data.batching import collate
from transformer_tts_tpu_torch.data.sampler import (
    LengthsBatchSampler, NumBatchSampler)


class DataLoader:
    def __init__(self, dataset, hp):
        self.dataset = dataset
        self.hp = hp
        if hp.batch_size is not None:
            self.sampler = NumBatchSampler(len(dataset), hp.batch_size,
                                           seed=hp.seed)
        elif hp.max_seqlen is not None:
            self.sampler = LengthsBatchSampler(
                dataset.mel_lengths(hp.lengths_file), hp.max_seqlen,
                seed=hp.seed, sort_by_length=hp.sort_by_length)
        else:
            raise ValueError("set hp.batch_size or hp.max_seqlen")

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for indices in self.sampler:
            yield collate([self.dataset[i] for i in indices], self.hp,
                          pad_batch=True)
