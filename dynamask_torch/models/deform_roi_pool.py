"""The box extractor of the DeformRoIPool configs (port of
``dynamask_tpu/models/roi_head.py:33-80``, ``DeformRoIPoolPackExtractor``;
``configs/dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py`` and ``..._mdpool_...``).

A pass of ``ops.multilevel_deform_roi_pool`` without offsets, its crop
(flattened in mmdet's (C, y, x) order) through ``offset_fc``: two
1024-wide fcs with ReLU and a zero-initialised fc to each bin's
``(dy, dx)`` (JAX's ``offset_fc1``, ``offset_fc2``, ``offset_out``), then
a second pass at those offsets. ``modulated`` multiplies each bin by a
sigmoid of ``mask_fc``, a zero-initialised fc on the offset branch's
hidden layer (JAX's ``mask_out``). Plain PyTorch, no kernel: XLA in JAX.

JAX's tree is not mmdet's (ROADMAP.md queue 3, 3bt): one offset branch
shared by the levels where mmdet's ``SingleRoIExtractor`` holds one
``DeformRoIPoolingPack`` a level (``roi_layers.{i}.``), and the modulated
mask on the offset branch's hidden layer where mmdet's
``ModulatedDeformRoIPoolingPack`` has a two-layer ``mask_fc`` of its own.
So an mmdet checkpoint's ``roi_layers.{i}.*`` tensors are refused by name
on load (:meth:`weight_fault`), never reshaped into JAX's layout.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.roi_pool import multilevel_deform_roi_pool
from .layers import WeightFaults


class DeformRoIPoolPack(WeightFaults, nn.Module):
    def __init__(self, in_channels: int = 256, out_size: int = 7,
                 featmap_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 trans_std: float = 0.1, sample_per_part: int = 4,
                 modulated: bool = False, fc_channels: int = 1024,
                 finest_scale: int = 56):
        super().__init__()
        self.out_size = out_size
        self.featmap_strides = tuple(featmap_strides)
        self.trans_std = trans_std
        self.sample_per_part = sample_per_part
        self.finest_scale = finest_scale
        self.modulated = modulated
        s2 = out_size * out_size
        self.offset_fc = nn.Sequential(
            nn.Linear(in_channels * s2, fc_channels), nn.ReLU(),
            nn.Linear(fc_channels, fc_channels), nn.ReLU(),
            nn.Linear(fc_channels, s2 * 2))
        # flax's default Dense init (LeCun normal), the last fc at zero
        for i in (0, 2):
            self.offset_fc[i].init_rule = 'lecun'
        self.offset_fc[4].init_rule = 0.0
        if modulated:
            self.mask_fc = nn.Linear(fc_channels, s2)
            self.mask_fc.init_rule = 0.0

    def _pool(self, feats, rois, roi_batch, offsets=None):
        return multilevel_deform_roi_pool(
            feats, rois, roi_batch, self.out_size, self.featmap_strides,
            offsets=offsets, finest_scale=self.finest_scale,
            trans_std=self.trans_std, sample_per_part=self.sample_per_part)

    def forward(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_batch: torch.Tensor) -> torch.Tensor:
        """NHWC levels (B, H_l, W_l, C), (N, 4) RoIs -> (N, s, s, C)."""
        s = self.out_size
        base = self._pool(feats, rois, roi_batch)
        x = base.permute(0, 3, 1, 2).reshape(base.shape[0], -1)
        for fc in (self.offset_fc[0], self.offset_fc[2]):
            x = torch.relu(fc(x))
        offsets = self.offset_fc[4](x).reshape(-1, s, s, 2)
        pooled = self._pool(feats, rois, roi_batch, offsets)
        if self.modulated:
            pooled = pooled * torch.sigmoid(self.mask_fc(x)).reshape(
                -1, s, s, 1)
        return pooled

    def weight_fault(self, key: str, shape) -> Optional[str]:
        if re.match(r'^(roi_layers|mask_fc)\.\d+\.', key):
            return (f'bbox_roi_extractor.{key}: an mmdet DeformRoIPoolPack '
                    'tensor the JAX package\'s extractor has no place for '
                    '(one offset branch for every level, the modulated '
                    'mask on its hidden layer; ROADMAP.md queue 3, 3bt); '
                    'it is not reshaped')
        return None
