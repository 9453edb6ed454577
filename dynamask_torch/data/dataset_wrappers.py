"""Dataset composition wrappers (port of
``dynamask_tpu/data/dataset_wrappers.py:20-104``): ``ConcatDataset``,
``RepeatDataset`` and ``ClassBalancedDataset``, the LVIS paper's repeat
factor sampling. Their lengths, orientation ``flags`` and index maps are
the JAX package's, so ``GroupedBatchSampler`` visits the same batches.

Each wrapper also has ``prepare(idx, rng)``, the item with its pipeline's
random draws taken from ``rng``, which the loader uses to seed them.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, List, Sequence

import numpy as np

from ..utils.registry import DATASETS


def _flags(dataset) -> np.ndarray:
    return getattr(dataset, 'flags', np.zeros(len(dataset), np.int64))


@DATASETS.register_module()
class ConcatDataset:
    """The datasets one after another."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cumulative = np.cumsum([len(d) for d in self.datasets])
        self.CLASSES = getattr(self.datasets[0], 'CLASSES', ())
        self.flags = np.concatenate([_flags(d) for d in self.datasets])

    def __len__(self):
        return int(self.cumulative[-1])

    def _locate(self, idx):
        ds = int(np.searchsorted(self.cumulative, idx, side='right'))
        base = 0 if ds == 0 else int(self.cumulative[ds - 1])
        return self.datasets[ds], idx - base

    def __getitem__(self, idx):
        return self.prepare(idx)

    def prepare(self, idx, rng=None):
        dataset, i = self._locate(idx)
        return dataset.prepare(i, rng)


@DATASETS.register_module()
class RepeatDataset:
    """``dataset`` ``times`` over."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = getattr(dataset, 'CLASSES', ())
        self.flags = np.tile(_flags(dataset), times)

    def __len__(self):
        return self.times * len(self.dataset)

    def __getitem__(self, idx):
        return self.prepare(idx)

    def prepare(self, idx, rng=None):
        return self.dataset.prepare(idx % len(self.dataset), rng)


@DATASETS.register_module()
class ClassBalancedDataset:
    """Oversample images that hold rare categories (reference
    dataset_wrappers.py:99-, LVIS paper eq. (1)): image I repeats
    ceil(max over its categories c of max(1, sqrt(t / f(c)))) times, f(c)
    the share of images holding c and t ``oversample_thr``."""

    def __init__(self, dataset, oversample_thr: float):
        self.dataset = dataset
        self.CLASSES = getattr(dataset, 'CLASSES', ())
        num_images = len(dataset)
        cat_img_count = defaultdict(int)
        img_cats: List[set] = []
        for idx in range(num_images):
            cats = set(int(c) for c in dataset.get_ann_info(idx)['labels'])
            img_cats.append(cats)
            for c in cats:
                cat_img_count[c] += 1
        cat_repeat = {c: max(1.0, math.sqrt(oversample_thr /
                                            (n / num_images)))
                      for c, n in cat_img_count.items()}
        indices = []
        for idx, cats in enumerate(img_cats):
            r = max((cat_repeat[c] for c in cats), default=1.0)
            indices.extend([idx] * int(math.ceil(r)))
        self.indices = np.asarray(indices, np.int64)
        self.flags = _flags(dataset)[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        return self.prepare(idx)

    def prepare(self, idx, rng=None):
        return self.dataset.prepare(int(self.indices[idx]), rng)


WRAPPERS = ('RepeatDataset', 'ClassBalancedDataset', 'ConcatDataset')


def wrap_dataset(cfg: dict, build_fn: Callable):
    """Build a wrapper config, its inner datasets through ``build_fn``
    (reference datasets/builder.py:49-66)."""
    t = cfg.get('type')
    if t == 'RepeatDataset':
        return RepeatDataset(build_fn(cfg['dataset']), cfg['times'])
    if t == 'ClassBalancedDataset':
        return ClassBalancedDataset(build_fn(cfg['dataset']),
                                    cfg['oversample_thr'])
    if t == 'ConcatDataset':
        return ConcatDataset([build_fn(c) for c in cfg['datasets']])
    return build_fn(cfg)
