"""Host-side mask containers (port of
``dynamask_tpu/core/mask_structures.py``, the reference's
``mmdet/core/mask/structures.py``): ``BitmapMasks`` and ``PolygonMasks``
with rescale, resize, flip, pad, crop, crop_and_resize, areas and
to_ndarray (``BitmapMasks.expand`` and ``PolygonMasks.to_bitmap`` too),
and ``polygon_to_bitmap``.
numpy and cv2; ``crop_and_resize`` goes through the port's RoIAlign on
CPU tensors (its plain version). They serve annotation handling and
tooling; the device path takes fixed-size GT crops
(``data/formatting.py``)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def _keep_ratio_size(height: int, width: int, scale) -> Tuple[int, int]:
    """(new_h, new_w) of a rescale by a factor, or to fit a (max_long,
    max_short) pair."""
    if isinstance(scale, (float, int)):
        f = float(scale)
    else:
        max_long, max_short = max(scale), min(scale)
        f = min(max_long / max(height, width), max_short / min(height, width))
    return int(height * f + 0.5), int(width * f + 0.5)


def _crop_box(bbox, height: int, width: int):
    x1, y1, x2, y2 = np.asarray(bbox).astype(int).flatten()[:4]
    x1 = np.clip(x1, 0, width)
    y1 = np.clip(y1, 0, height)
    x2 = np.clip(x2, x1 + 1, width)
    y2 = np.clip(y2, y1 + 1, height)
    return x1, y1, x2, y2


class BitmapMasks:
    """Masks as an (N, H, W) uint8 stack."""

    def __init__(self, masks, height: int, width: int):
        self.height = height
        self.width = width
        if len(masks) == 0:
            self.masks = np.empty((0, height, width), np.uint8)
        else:
            self.masks = np.stack(masks).reshape(-1, height, width) \
                .astype(np.uint8)

    def __len__(self) -> int:
        return len(self.masks)

    def __getitem__(self, index) -> 'BitmapMasks':
        return BitmapMasks(self.masks[index].reshape(-1, self.height,
                                                     self.width),
                           self.height, self.width)

    def __iter__(self):
        return iter(self.masks)

    def resize(self, out_shape: Tuple[int, int],
               interpolation='nearest') -> 'BitmapMasks':
        import cv2
        h, w = out_shape
        if len(self) == 0:
            return BitmapMasks([], h, w)
        return BitmapMasks(np.stack([
            cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
            for m in self.masks]), h, w)

    def rescale(self, scale, interpolation='nearest') -> 'BitmapMasks':
        """By a factor, or to fit a (max_long, max_short) pair keeping the
        ratio; nearest."""
        return self.resize(_keep_ratio_size(self.height, self.width, scale))

    def flip(self, flip_direction='horizontal') -> 'BitmapMasks':
        assert flip_direction in ('horizontal', 'vertical')
        axis = 2 if flip_direction == 'horizontal' else 1
        return BitmapMasks(np.flip(self.masks, axis=axis), self.height,
                           self.width)

    def pad(self, out_shape: Tuple[int, int], pad_val: int = 0
            ) -> 'BitmapMasks':
        h, w = out_shape
        if len(self) == 0:
            return BitmapMasks([], h, w)
        padded = np.full((len(self), h, w), pad_val, np.uint8)
        padded[:, :self.height, :self.width] = self.masks
        return BitmapMasks(padded, h, w)

    def crop(self, bbox: np.ndarray) -> 'BitmapMasks':
        x1, y1, x2, y2 = _crop_box(bbox, self.height, self.width)
        return BitmapMasks(self.masks[:, y1:y2, x1:x2], y2 - y1, x2 - x1)

    def crop_and_resize(self, bboxes: np.ndarray,
                        out_shape: Tuple[int, int], inds: np.ndarray,
                        device=None, interpolation='bilinear'
                        ) -> 'BitmapMasks':
        """Each box's crop of mask ``inds[i]`` at ``out_shape`` (square),
        RoIAlign (aligned, ratio 2) thresholded at 0.5: the mask targets'
        extraction. ``device`` is taken for the reference's signature."""
        import torch
        from ..ops.roi_align import roi_align
        out_h, out_w = out_shape
        if out_h != out_w:
            raise ValueError(f'crop_and_resize: square targets only, got '
                             f'{out_shape}')
        if len(bboxes) == 0 or len(self) == 0:
            return BitmapMasks([], out_h, out_w)
        out = roi_align(
            torch.from_numpy(self.masks[:, :, :, None].astype(np.float32)),
            torch.as_tensor(np.asarray(bboxes), dtype=torch.float32),
            torch.as_tensor(np.asarray(inds), dtype=torch.int64), out_h,
            1.0, sampling_ratio=2, aligned=True)
        return BitmapMasks((out[..., 0].numpy() >= 0.5).astype(np.uint8),
                           out_h, out_w)

    def expand(self, expanded_h: int, expanded_w: int, top: int,
               left: int) -> 'BitmapMasks':
        if len(self) == 0:
            return BitmapMasks([], expanded_h, expanded_w)
        out = np.zeros((len(self), expanded_h, expanded_w), np.uint8)
        out[:, top:top + self.height, left:left + self.width] = self.masks
        return BitmapMasks(out, expanded_h, expanded_w)

    @property
    def areas(self) -> np.ndarray:
        return self.masks.sum((1, 2))

    def to_ndarray(self) -> np.ndarray:
        return self.masks

    def to_tensor(self, dtype=None, device=None):
        import torch
        return torch.as_tensor(self.masks, dtype=dtype or torch.uint8,
                               device=device)


class PolygonMasks:
    """Masks as per-instance lists of flat polygons."""

    def __init__(self, masks: Sequence[Sequence[np.ndarray]], height: int,
                 width: int):
        self.height = height
        self.width = width
        self.masks = [[np.asarray(p, np.float32).reshape(-1) for p in m]
                      for m in masks]

    def __len__(self) -> int:
        return len(self.masks)

    def __getitem__(self, index) -> 'PolygonMasks':
        if isinstance(index, (int, np.integer)):
            sel = [self.masks[index]]
        elif isinstance(index, np.ndarray):
            idxs = np.nonzero(index)[0] if index.dtype == bool else index
            sel = [self.masks[i] for i in idxs]
        else:
            sel = self.masks[index]
        return PolygonMasks(sel, self.height, self.width)

    def _transform(self, fx, fy, dx, dy, h, w) -> 'PolygonMasks':
        out = []
        for m in self.masks:
            polys = []
            for p in m:
                q = p.copy()
                q[0::2] = q[0::2] * fx + dx
                q[1::2] = q[1::2] * fy + dy
                polys.append(q)
            out.append(polys)
        return PolygonMasks(out, h, w)

    def rescale(self, scale, interpolation=None) -> 'PolygonMasks':
        """By a factor, or to fit a (max_long, max_short) pair keeping the
        ratio: the vertices times the factor."""
        if isinstance(scale, (float, int)):
            f = float(scale)
        else:
            max_long, max_short = max(scale), min(scale)
            f = min(max_long / max(self.height, self.width),
                    max_short / min(self.height, self.width))
        h, w = _keep_ratio_size(self.height, self.width, scale)
        return self._transform(f, f, 0, 0, h, w)

    def resize(self, out_shape, interpolation=None) -> 'PolygonMasks':
        h, w = out_shape
        return self._transform(w / self.width, h / self.height, 0, 0, h, w)

    def flip(self, flip_direction='horizontal') -> 'PolygonMasks':
        out = []
        for m in self.masks:
            polys = []
            for p in m:
                q = p.copy()
                if flip_direction == 'horizontal':
                    q[0::2] = self.width - q[0::2]
                else:
                    q[1::2] = self.height - q[1::2]
                polys.append(q)
            out.append(polys)
        return PolygonMasks(out, self.height, self.width)

    def pad(self, out_shape, pad_val=0) -> 'PolygonMasks':
        return PolygonMasks(self.masks, *out_shape)

    def crop(self, bbox) -> 'PolygonMasks':
        x1, y1, x2, y2 = _crop_box(bbox, self.height, self.width)
        return self._transform(1, 1, -x1, -y1, y2 - y1, x2 - x1)

    def crop_and_resize(self, bboxes, out_shape, inds, device=None,
                        interpolation='bilinear') -> 'BitmapMasks':
        return self.to_bitmap().crop_and_resize(bboxes, out_shape, inds,
                                                device, interpolation)

    @property
    def areas(self) -> np.ndarray:
        """The shoelace area, summed over each instance's polygons."""
        out = []
        for m in self.masks:
            a = 0.0
            for p in m:
                x, y = p[0::2], p[1::2]
                a += 0.5 * abs(np.dot(x, np.roll(y, 1)) -
                               np.dot(y, np.roll(x, 1)))
            out.append(a)
        return np.asarray(out)

    def to_bitmap(self) -> BitmapMasks:
        from ..data.mask_codec import polygons_to_mask
        return BitmapMasks([polygons_to_mask(list(m), self.height,
                                             self.width)
                            for m in self.masks], self.height, self.width)

    def to_ndarray(self) -> np.ndarray:
        return self.to_bitmap().to_ndarray()


def polygon_to_bitmap(polygons, height: int, width: int) -> np.ndarray:
    """COCO polygons -> an (h, w) bool mask."""
    from ..data.mask_codec import polygons_to_mask
    return polygons_to_mask(polygons, height, width).astype(bool)
