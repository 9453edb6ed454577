"""Batched data loading with orientation bucketing (port of
``dynamask_tpu/data/loader.py``).

``GroupedBatchSampler`` is the JAX package's, unchanged: epoch-seeded numpy
shuffles within each orientation group (one static canvas per group), so
with the same seed the two packages visit the same batches in the same
order. ``build_dataloader`` puts it behind ``torch.utils.data.DataLoader``,
whose worker processes take the place of the JAX loader's thread pool, and
seeds each sample's pipeline draws from the seed, the epoch and the index
(the JAX loader leaves them unseeded), so that a resumed run loads what
the straight run loaded.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np
from torch.utils.data import DataLoader, Dataset

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


def sample_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of one sample's pipeline draws (flip, scale) in an epoch."""
    return int(np.random.SeedSequence([seed, epoch, index])
               .generate_state(1)[0])


class SeededBatches:
    """``sampler``'s batches, each index paired with the seed of its
    sample's pipeline draws, from the sampler's seed, its epoch and the
    index. An epoch then loads the same batches however the run got there,
    so a resumed run loads what the straight run loaded. ``set_epoch`` and
    ``len`` are the sampler's."""

    def __init__(self, sampler: GroupedBatchSampler):
        self.sampler = sampler

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[List[Tuple[int, int]]]:
        s = self.sampler
        for batch in s:
            yield [(int(i), sample_seed(s.seed, s.epoch, int(i)))
                   for i in batch]


class SeededItems(Dataset):
    """``dataset`` indexed by ``(index, seed)``: the item, its pipeline's
    draws from ``RandomState(seed)``."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, key: Tuple[int, int]):
        idx, seed = key
        return self.dataset.prepare(idx, np.random.RandomState(seed))


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 4,
                     shuffle: bool = True, seed: int = 0,
                     drop_last: Optional[bool] = None, num_shards: int = 1,
                     shard_index: int = 0) -> DataLoader:
    """A ``DataLoader`` over ``dataset`` in ``GroupedBatchSampler`` batches,
    collated into torch tensors by ``workers_per_gpu`` worker processes
    (started with ``spawn`` at the first epoch and kept for the next ones;
    0 loads in the calling process). Each sample's pipeline draws are
    seeded from ``seed``, the epoch and its index (:class:`SeededBatches`),
    whichever shard loads it. ``loader.batch_sampler.set_epoch(e)``
    reseeds the shuffle and the draws.

    ``num_shards`` / ``shard_index``: one rank's share of each global batch
    of ``samples_per_gpu * num_shards`` images, the rule of the JAX
    package's multi-process loader (``dynamask_tpu/data/loader.py:62-64``):
    rank ``r`` takes ``chunk[r::num_shards]`` of each global chunk, and
    every rank sees the same number of batches. At ``samples_per_gpu > 1``
    this pairs images with ranks otherwise than JAX's single-process mesh,
    which splits each chunk into contiguous blocks; the set of images in
    each global batch is the same."""
    if drop_last is None:
        drop_last = shuffle  # train drops ragged tails; eval keeps all
    flags = getattr(dataset, 'flags', np.zeros(len(dataset), np.int64))
    sampler = GroupedBatchSampler(flags, samples_per_gpu, shuffle=shuffle,
                                  seed=seed, num_shards=num_shards,
                                  shard_index=shard_index,
                                  drop_last=drop_last)
    workers = dict(num_workers=workers_per_gpu, worker_init_fn=_worker_init,
                   multiprocessing_context='spawn',
                   persistent_workers=True) if workers_per_gpu else {}
    return DataLoader(SeededItems(dataset),
                      batch_sampler=SeededBatches(sampler),
                      collate_fn=collate, **workers)
