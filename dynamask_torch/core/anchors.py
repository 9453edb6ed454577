"""Grid anchors and their validity (port of ``AnchorGenerator`` and
``LegacyAnchorGenerator`` in ``dynamask_tpu/core/anchors.py``, :20-160;
SSD's, :161-244).

Base anchors and grids are computed in numpy from static feature-map sizes,
then moved to the device once per call.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    """Multi-level anchors: ``w = base * scale / sqrt(ratio)``,
    ``h = base * scale * sqrt(ratio)``, scale-major, centred at
    ``center_offset * stride``. The scales are given, or are
    ``octave_base_scale * 2 ** (i / scales_per_octave)`` (RetinaNet's
    octave scales; ATSS's single one)."""

    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Optional[Sequence[float]] = None,
                 octave_base_scale: Optional[float] = None,
                 scales_per_octave: Optional[int] = None,
                 center_offset: float = 0.0):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s)
                        for s in strides]
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            octave = 2 ** (np.arange(scales_per_octave) / scales_per_octave)
            self.scales = (octave * octave_base_scale).astype(np.float32)
        else:
            raise ValueError('either scales or octave_base_scale and '
                             'scales_per_octave must be set')
        self.ratios = np.asarray(ratios, np.float32)
        self.center_offset = center_offset
        self.base_anchors = [self._base_anchors(min(s), s)
                             for s in self.strides]

    @property
    def num_base_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)

    def _sizes(self, base_size: float):
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
        hs = (base_size * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
        return ws, hs

    def _base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._sizes(base_size)
        xc = self.center_offset * stride[0]
        yc = self.center_offset * stride[1]
        return np.stack([xc - 0.5 * ws, yc - 0.5 * hs, xc + 0.5 * ws,
                         yc + 0.5 * hs], axis=-1).astype(np.float32)

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
        num_base = self.num_base_anchors
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


class LegacyAnchorGenerator(AnchorGenerator):
    """mmdet v1.x's anchors (the ``legacy_1.x`` configs): centred at
    ``center_offset * (stride - 1)``, with the ``- 1`` of the +1-pixel box
    convention on their extent."""

    def _base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._sizes(base_size)
        xc = self.center_offset * (stride[0] - 1)
        yc = self.center_offset * (stride[1] - 1)
        return np.stack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                         xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)],
                        axis=-1).astype(np.float32)


class SSDAnchorGenerator(AnchorGenerator):
    """SSD's anchors (port of ``SSDAnchorGenerator`` and
    ``LegacySSDAnchorGenerator``, ``dynamask_tpu/core/anchors.py:161-244``):
    a level's min and max sizes from the input size and an integer
    percent range, the first level's fixed at 7-15% (a range from 0.15)
    or 10-20% (any other); a level's anchors are (scale 1, ratio 1),
    (sqrt(max / min), ratio 1), then scale 1 at each ratio 1/r, r of its
    list, centred at half the stride. The grids are made once per
    feature-map sizes and device and kept there."""

    def __init__(self, strides: Sequence[int],
                 ratios: Sequence[Sequence[float]],
                 basesize_ratio_range: Tuple[float, float] = (0.15, 0.9),
                 input_size: int = 300):
        self.strides = [(s, s) if isinstance(s, int) else tuple(s)
                        for s in strides]
        num_levels = len(self.strides)
        lo, hi = (int(r * 100) for r in basesize_ratio_range)
        step = int(np.floor(hi - lo) / (num_levels - 2))
        min_sizes = [int(input_size * r / 100)
                     for r in range(lo, hi + 1, step)]
        max_sizes = [int(input_size * (r + step) / 100)
                     for r in range(lo, hi + 1, step)]
        first = (7, 15) if basesize_ratio_range[0] == 0.15 else (10, 20)
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
        min_sizes, max_sizes = min_sizes[:num_levels], max_sizes[:num_levels]
        self.base_anchors = []
        for lvl, (stride, rs) in enumerate(zip(self.strides, ratios)):
            self.scales = np.asarray(
                [1.0, np.sqrt(max_sizes[lvl] / min_sizes[lvl])], np.float32)
            full = [1.0]
            for r in rs:
                full += [1.0 / r, r]
            self.ratios = np.asarray(full, np.float32)
            a = self._base_anchors(min_sizes[lvl], stride).reshape(
                len(full), 2, 4)
            self.base_anchors.append(np.stack(
                [a[0, 0], a[0, 1]] + [a[i, 0] for i in range(1, len(full))]))
        self._grids = {}

    @property
    def num_base_anchors(self) -> List[int]:
        return [len(a) for a in self.base_anchors]

    def _sizes(self, base_size: float):
        # ratio-major: (ratio, scale) rows, in JAX's order of products
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (base_size * self.scales[None, :] * w_ratios[:, None])
        hs = (base_size * self.scales[None, :] * h_ratios[:, None])
        return ws.reshape(-1), hs.reshape(-1)

    def _base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._sizes(float(base_size))
        xc, yc = 0.5 * stride[0], 0.5 * stride[1]
        return np.stack([xc - 0.5 * ws, yc - 0.5 * hs, xc + 0.5 * ws,
                         yc + 0.5 * hs], axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     device=None) -> List[torch.Tensor]:
        key = (tuple(map(tuple, featmap_sizes)), str(device))
        if key not in self._grids:
            self._grids[key] = super().grid_anchors(featmap_sizes, device)
        return self._grids[key]

    def valid_flags(self, featmap_sizes: Sequence[Tuple[int, int]],
                    img_shape: torch.Tensor) -> List[torch.Tensor]:
        flags = []
        for level, (feat_h, feat_w) in enumerate(featmap_sizes):
            sw, sh = self.strides[level]
            h = torch.ceil(img_shape[:, 0] / sh).long().clamp(max=feat_h)
            w = torch.ceil(img_shape[:, 1] / sw).long().clamp(max=feat_w)
            ys = torch.arange(feat_h, device=img_shape.device)
            xs = torch.arange(feat_w, device=img_shape.device)
            valid = ((ys[None, :, None] < h[:, None, None]) &
                     (xs[None, None, :] < w[:, None, None]))
            flags.append(valid.reshape(img_shape.shape[0], -1)
                         .repeat_interleave(self.num_base_anchors[level],
                                            dim=1))
        return flags


class LegacySSDAnchorGenerator(SSDAnchorGenerator):
    """mmdet v1.x's SSD anchors: centred at ``(stride - 1) / 2``, with the
    ``- 1`` of the +1-pixel box convention on their extent."""

    def _base_anchors(self, base_size: float, stride) -> np.ndarray:
        ws, hs = self._sizes(float(base_size))
        xc, yc = 0.5 * (stride[0] - 1), 0.5 * (stride[1] - 1)
        return np.stack([xc - 0.5 * (ws - 1), yc - 0.5 * (hs - 1),
                         xc + 0.5 * (ws - 1), yc + 0.5 * (hs - 1)],
                        axis=-1).astype(np.float32)
