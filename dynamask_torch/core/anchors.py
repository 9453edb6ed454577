"""Grid anchors and their validity (port of ``AnchorGenerator.grid_anchors``
and ``valid_flags`` in ``dynamask_tpu/core/anchors.py``, :108-131).

Base anchors and grids are computed in numpy from static feature-map sizes,
then moved to the device once per call.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    """Multi-level anchors: ``w = base * scale / sqrt(ratio)``,
    ``h = base * scale * sqrt(ratio)``, scale-major, centred at 0."""

    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Sequence[float]):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s)
                        for s in strides]
        self.scales = np.asarray(scales, np.float32)
        self.ratios = np.asarray(ratios, np.float32)
        self.base_anchors = [self._base_anchors(min(s)) for s in self.strides]

    def _base_anchors(self, base_size: float) -> np.ndarray:
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs],
                        axis=-1).astype(np.float32)

    def single_level_grid_anchors(self, featmap_size: Tuple[int, int],
                                  level: int) -> np.ndarray:
        """``(H*W*A, 4)`` anchors of one level, location-major."""
        feat_h, feat_w = featmap_size
        stride_w, stride_h = self.strides[level]
        shift_x = np.arange(feat_w, dtype=np.float32) * stride_w
        shift_y = np.arange(feat_h, dtype=np.float32) * stride_h
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 4)
        anchors = shifts[:, None, :] + self.base_anchors[level][None, :, :]
        return anchors.reshape(-1, 4)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     device=None) -> List[torch.Tensor]:
        assert len(featmap_sizes) == len(self.strides)
        return [torch.from_numpy(self.single_level_grid_anchors(fs, i)).to(
                    device) for i, fs in enumerate(featmap_sizes)]

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    img_shape: torch.Tensor) -> List[torch.Tensor]:
        """Per level, (B, H*W*A) bool: an anchor location is valid when it
        lies inside the un-padded image extent ``img_shape`` (B, 2) = (h, w)
        on that level, ``ceil(extent / stride)`` cells."""
        flags = []
        num_base = len(self.scales) * len(self.ratios)
        for level, (feat_h, feat_w) in enumerate(featmap_sizes):
            sw, sh = self.strides[level]
            h = torch.ceil(img_shape[:, 0] / sh).long().clamp(max=feat_h)
            w = torch.ceil(img_shape[:, 1] / sw).long().clamp(max=feat_w)
            ys = torch.arange(feat_h, device=img_shape.device)
            xs = torch.arange(feat_w, device=img_shape.device)
            valid = ((ys[None, :, None] < h[:, None, None]) &
                     (xs[None, None, :] < w[:, None, None]))
            flags.append(valid.reshape(img_shape.shape[0], -1)
                         .repeat_interleave(num_base, dim=1))
        return flags
