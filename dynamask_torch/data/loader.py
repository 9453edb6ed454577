"""Batched data loading with orientation bucketing (port of
``dynamask_tpu/data/loader.py``).

``GroupedBatchSampler`` is the JAX package's, unchanged: epoch-seeded numpy
shuffles within each orientation group (one static canvas per group), so
with the same seed the two packages visit the same batches in the same
order. ``build_dataloader`` puts it behind ``torch.utils.data.DataLoader``,
whose worker processes take the place of the JAX loader's thread pool.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np
from torch.utils.data import DataLoader

from .formatting import collate


class GroupedBatchSampler:
    """Epoch-seeded shuffled batches, grouped by dataset.flags
    (reference samplers/group_sampler.py:GroupSampler/DistributedGroupSampler)."""

    def __init__(self, flags: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0,
                 drop_last: bool = True):
        self.flags = np.asarray(flags)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """DistSamplerSeedHook equivalent (reference apis/train.py:110)."""
        self.epoch = epoch

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        batches = []
        for flag in np.unique(self.flags):
            idxs = np.nonzero(self.flags == flag)[0]
            if self.shuffle:
                rng.shuffle(idxs)
            # pad each group to a multiple of the global batch (reference
            # GroupSampler), or drop its ragged tail
            total = self.batch_size * self.num_shards
            pad = (-len(idxs)) % total
            if pad and not self.drop_last:
                # np.resize tiles as often as needed, so a group smaller
                # than the global batch still pads to a full multiple
                idxs = np.resize(idxs, len(idxs) + pad)
            elif self.drop_last:
                idxs = idxs[:len(idxs) - (len(idxs) % total)]
            for s in range(0, len(idxs), total):
                chunk = idxs[s:s + total]
                if len(chunk) == total:
                    shard = chunk[self.shard_index::self.num_shards]
                    batches.append(list(shard))
        if self.shuffle:
            order = rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        return iter(batches)

    def __len__(self) -> int:
        n = 0
        total = self.batch_size * self.num_shards
        for flag in np.unique(self.flags):
            c = int((self.flags == flag).sum())
            n += (c // total) if self.drop_last else -(-c // total)
        return n


def _worker_init(worker_id: int) -> None:
    """Keep cv2 from starting a thread pool in each loader worker."""
    import cv2
    cv2.setNumThreads(0)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 4,
                     shuffle: bool = True, seed: int = 0,
                     drop_last: Optional[bool] = None) -> DataLoader:
    """A ``DataLoader`` over ``dataset`` in ``GroupedBatchSampler`` batches,
    collated into torch tensors by ``workers_per_gpu`` worker processes
    (started with ``spawn``; 0 loads in the calling process). The sampler
    is ``loader.batch_sampler``: ``loader.batch_sampler.set_epoch(e)``
    reseeds the shuffle."""
    if drop_last is None:
        drop_last = shuffle  # train drops ragged tails; eval keeps all
    flags = getattr(dataset, 'flags', np.zeros(len(dataset), np.int64))
    sampler = GroupedBatchSampler(flags, samples_per_gpu, shuffle=shuffle,
                                  seed=seed, drop_last=drop_last)
    workers = dict(num_workers=workers_per_gpu, worker_init_fn=_worker_init,
                   multiprocessing_context='spawn') if workers_per_gpu else {}
    return DataLoader(dataset, batch_sampler=sampler, collate_fn=collate,
                      **workers)
