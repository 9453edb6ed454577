"""Training entry points: build the detector and its optimizer from a
config and run steps on given batches (a ``build_dataloader`` batch, or the
seeded synthetic batch here, in the same training batch contract as the
JAX package's)."""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..engine.optimizer import DetectorSGD, build_optimizer
from ..engine.train import make_train_step
from ..utils.config import Config
from .inference import init_detector


def init_trainer(config: Union[str, Config], *, steps_per_epoch: int,
                 device=None, seed: int = 0
                 ) -> Tuple[torch.nn.Module, DetectorSGD]:
    """The config's detector in training mode (frozen stages frozen,
    backbone BatchNorms on running statistics), initialised from ``seed``
    as the JAX package initialises it, and its optimizer (``optimizer``,
    ``optimizer_config``, ``lr_config``). The lr steps down at the epochs
    of ``lr_config.step``, counted in ``steps_per_epoch`` optimizer steps
    (the JAX trainer takes it from its loader's length)."""
    model = init_detector(config, device=device, seed=seed)
    cfg = model.cfg
    opt = build_optimizer(model, cfg.optimizer, cfg.get('optimizer_config'),
                          cfg.get('lr_config'),
                          steps_per_epoch=steps_per_epoch)
    return model.train(), opt


def train_detector(model: torch.nn.Module, optimizer: DetectorSGD,
                   batches: Iterable[Dict[str, torch.Tensor]],
                   generator: Optional[torch.Generator] = None
                   ) -> List[Dict[str, torch.Tensor]]:
    """One optimizer step per batch; returns each step's log (losses,
    ``loss``, ``grad_norm``). Random draws come from ``generator``."""
    step = make_train_step(model, optimizer)
    dev = model.device
    return [step({k: v.to(dev) for k, v in b.items()}, generator=generator)
            for b in batches]


def synthetic_batch(seed: int, b: int = 1, h: int = 128, w: int = 128,
                    num_gts: int = 4, max_gts: Optional[int] = None,
                    crop_size: int = 32, num_classes: int = 80,
                    device=None) -> Dict[str, torch.Tensor]:
    """A padded training batch from ``seed``: N(0, 1) NHWC images, boxes of
    10-40% of the image side, elliptic mask crops over windows 2 px larger
    than the boxes; ``num_gts`` valid GTs in ``max_gts`` slots."""
    r = np.random.RandomState(seed)
    g = max_gts or num_gts
    side = min(h, w)
    cx, cy = r.uniform(0.1, 0.9, (2, b, g)) * np.asarray([[[w]], [[h]]])
    bw, bh = r.uniform(0.1, 0.4, (2, b, g)) * side
    boxes = np.stack([np.clip(cx - bw / 2, 0, w), np.clip(cy - bh / 2, 0, h),
                      np.clip(cx + bw / 2, 0, w), np.clip(cy + bh / 2, 0, h)],
                     -1).astype(np.float32)
    valid = np.broadcast_to(np.arange(g) < num_gts, (b, g)).copy()
    boxes[~valid] = 0.0
    grid = (np.arange(crop_size) + 0.5) / crop_size - 0.5
    ry, rx = r.uniform(0.25, 0.5, (2, b, g, 1, 1))
    crops = ((grid[:, None] / ry) ** 2 + (grid[None, :] / rx) ** 2 <= 1.0)
    batch = {
        'image': r.randn(b, h, w, 3).astype(np.float32),
        'img_shape': np.tile([[h, w]], (b, 1)).astype(np.float32),
        'gt_boxes': boxes,
        'gt_labels': r.randint(0, num_classes, (b, g)).astype(np.int64),
        'gt_valid': valid,
        'gt_crops': (crops & valid[..., None, None]).astype(np.uint8),
        'gt_windows': boxes + np.asarray([-2, -2, 2, 2], np.float32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
