"""Training batches (the port of ``DataLoader``,
transformer_tts_tpu/data/loader.py:22-99).

The sampler comes from the hparams: ``batch_size`` gives a
``NumBatchSampler``, ``max_seqlen`` a frame-budget ``LengthsBatchSampler``
over the mel lengths. Each batch is read (a dataset's
``load_batch_samples``, the native mel reader, where it has one) and
collated to bucket shapes with power-of-two batch padding.

Data parallelism: ``shard``/``num_shards`` (the rank and the number of
ranks) give each rank its disjoint share of every epoch's batches
(``shard_batches``, as many on every rank), and ``fixed_shapes`` (the
default with more than one shard) pads every batch to one shape, the top
text and mel buckets and the largest sampler batch, so the ranks' local
batches agree in shape and each rank's plain means over the padded shape
average under DDP to the global batch's.

``num_workers`` > 1 reads and collates batches on a thread pool,
``prefetch`` + ``num_workers`` of them ahead of the step (the file reads
and the native reader release the GIL); the batches come in the
sampler's order.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from transformer_tts_tpu_torch.data.batching import (
    collate, pick_batch_bucket)
from transformer_tts_tpu_torch.data.sampler import (
    LengthsBatchSampler, NumBatchSampler, shard_batches)


class DataLoader:
    def __init__(self, dataset, hp, *, num_workers: int = 1,
                 prefetch: int = 4, shard: int = 0, num_shards: int = 1,
                 fixed_shapes: Optional[bool] = None):
        self.dataset = dataset
        self.hp = hp
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.shard = shard
        self.num_shards = num_shards
        if hp.batch_size is not None:
            self.sampler = NumBatchSampler(len(dataset), hp.batch_size,
                                           seed=hp.seed)
        elif hp.max_seqlen is not None:
            self.sampler = LengthsBatchSampler(
                dataset.mel_lengths(hp.lengths_file), hp.max_seqlen,
                seed=hp.seed, sort_by_length=hp.sort_by_length)
        else:
            raise ValueError("set hp.batch_size or hp.max_seqlen")
        if fixed_shapes is None:
            fixed_shapes = num_shards > 1
        self.fixed = {}
        if fixed_shapes:
            self.fixed = dict(
                text_len=max(hp.text_buckets),
                mel_len=max(hp.length_buckets),
                batch=pick_batch_bucket(
                    max(len(b) for b in self.sampler.all_indices)))

    def __len__(self) -> int:
        n = len(self.sampler)
        return -(-n // self.num_shards) if self.num_shards > 1 else n

    def _load_batch(self, indices) -> Dict[str, np.ndarray]:
        if hasattr(self.dataset, "load_batch_samples"):
            samples = self.dataset.load_batch_samples(
                indices, n_threads=max(self.num_workers, 1))
        else:
            samples = [self.dataset[i] for i in indices]
        return collate(samples, self.hp, pad_batch=True, **self.fixed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = list(iter(self.sampler))
        if self.num_shards > 1:
            batches = shard_batches(batches, self.shard, self.num_shards)
        if self.num_workers <= 1:
            for indices in batches:
                yield self._load_batch(indices)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            ahead = queue.Queue()
            it = iter(batches)
            for indices in it:
                ahead.put(pool.submit(self._load_batch, indices))
                if ahead.qsize() >= self.prefetch + self.num_workers:
                    break
            while not ahead.empty():
                yield ahead.get().result()
                indices = next(it, None)
                if indices is not None:
                    ahead.put(pool.submit(self._load_batch, indices))
