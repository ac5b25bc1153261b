"""Batch samplers (the port of ``LengthsBatchSampler`` and
``NumBatchSampler``, transformer_tts_tpu/data/sampler.py:24-125, with the
settings the loader uses).

* ``LengthsBatchSampler``: frame-budget batching; greedily packs
  consecutive utterances (in length-sorted order by default) while
  ``max_len_in_batch * count <= budget``; an utterance over budget goes
  alone.
* ``NumBatchSampler``: a fixed batch size and a remainder batch.

Both reshuffle the batch order every epoch from ``seed``, as the JAX
package's do. ``shard_batches`` (:128-135) deals each data-parallel rank
every n-th batch of the epoch, the list first padded from its start to a
multiple of n, so the ranks take the same number of steps.
"""

from __future__ import annotations

import random
from typing import List, Sequence

import numpy as np


class LengthsBatchSampler:
    def __init__(self, lengths: np.ndarray, n_lengths: int, *,
                 seed: int = 77, sort_by_length: bool = True):
        self.lengths_np = np.asarray(lengths)
        self._order = (np.argsort(self.lengths_np, kind="stable")
                       if sort_by_length
                       else np.arange(len(self.lengths_np)))
        self.n_lengths = n_lengths
        self._rng = random.Random(seed)
        self.all_indices = self._batch_indices()

    def _batch_indices(self) -> List[List[int]]:
        all_indices = []
        count = 0
        n = len(self.lengths_np)
        while count + 1 < n:
            indices: List[int] = []
            max_len = 0
            while count < n:
                idx = int(self._order[count])
                curr = int(self.lengths_np[idx])
                if max(max_len, curr) * (len(indices) + 1) > self.n_lengths:
                    break
                max_len = max(max_len, curr)
                indices.append(idx)
                count += 1
            if not indices:   # a single utterance over budget goes alone
                indices.append(int(self._order[count]))
                count += 1
            all_indices.append(indices)
        return all_indices

    def __iter__(self):
        self._rng.shuffle(self.all_indices)
        yield from self.all_indices

    def __len__(self) -> int:
        return len(self.all_indices)


class NumBatchSampler:
    def __init__(self, dataset_len: int, batch_size: int, *,
                 seed: int = 77):
        self._rng = np.random.RandomState(seed)
        mod = dataset_len % batch_size
        self.all_indices = (np.arange(dataset_len - mod)
                            .reshape(-1, batch_size).tolist())
        if mod:
            self.all_indices.append(
                np.arange(dataset_len - mod, dataset_len).tolist())

    def __iter__(self):
        self._rng.shuffle(self.all_indices)
        yield from self.all_indices

    def __len__(self) -> int:
        return len(self.all_indices)


def shard_batches(batches: Sequence[Sequence[int]], shard: int,
                  num_shards: int) -> List[List[int]]:
    """Rank ``shard``'s batches of ``num_shards``: disjoint, and as many
    on every rank (the list padded with its first batches)."""
    batches = [list(b) for b in batches]
    per = -(-len(batches) // num_shards)
    padded = batches + batches[:per * num_shards - len(batches)]
    return padded[shard::num_shards]
