"""Box geometry on tensors, and the per-class det lists on the host (port of
``dynamask_tpu/core/bbox_transforms.py``).

Boxes are ``[x1, y1, x2, y2]``; padded slots travel with validity masks, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# dw/dh clamp ratio of the reference decoder (wh_ratio_clip=16/1000)
WH_RATIO_CLIP = 16.0 / 1000.0


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0) *
            (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  eps: float = 1e-6, mode: str = 'iou') -> torch.Tensor:
    """Pairwise IoU of ``(..., N, 4)`` and ``(..., M, 4)`` -> ``(..., N, M)``;
    ``mode='iof'``: the intersection over the area of ``boxes1``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = bbox_area(boxes1)[..., :, None]
    if mode == 'iof':
        return inter / area1.clamp(min=eps)
    area2 = bbox_area(boxes2)[..., None, :]
    return inter / (area1 + area2 - inter).clamp(min=eps)


def bbox2delta(proposals: torch.Tensor, gt: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.)) -> torch.Tensor:
    """Encode ``gt`` as (dx, dy, dw, dh) deltas w.r.t. ``proposals``."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=1e-6)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=1e-6)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw.clamp(min=1e-6) / pw),
                          torch.log(gh.clamp(min=1e-6) / ph)], dim=-1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def delta2bbox(rois: torch.Tensor, deltas: torch.Tensor,
               means: Sequence[float] = (0., 0., 0., 0.),
               stds: Sequence[float] = (1., 1., 1., 1.),
               max_shape: Optional[Tuple[float, float]] = None,
               wh_ratio_clip: float = WH_RATIO_CLIP) -> torch.Tensor:
    """Decode deltas on top of ``rois``; ``deltas`` may carry a trailing
    multiple-of-4 dim (per-class regression)."""
    shape = deltas.shape
    deltas4 = deltas.reshape(shape[:-1] + (-1, 4))
    denorm = deltas4 * deltas.new_tensor(stds) + deltas.new_tensor(means)
    dx, dy, dw, dh = denorm.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)

    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    if max_shape is not None:
        h, w = max_shape[0], max_shape[1]
        x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
        y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    return boxes.reshape(shape[:-1] + (shape[-1],))


def distance2bbox(points: torch.Tensor,
                  distance: torch.Tensor) -> torch.Tensor:
    """(left, top, right, bottom) distances around (x, y) points -> boxes
    (FCOS's decode)."""
    return torch.stack([points[..., 0] - distance[..., 0],
                        points[..., 1] - distance[..., 1],
                        points[..., 0] + distance[..., 2],
                        points[..., 1] + distance[..., 3]], dim=-1)


def bbox2result(bboxes, scores, labels, valid,
                num_classes: int) -> List[np.ndarray]:
    """Padded host dets -> the reference's per-class result format: a list
    of ``num_classes`` (k, 5) float32 arrays [x1, y1, x2, y2, score]
    (bbox/transforms.py:bbox2result), from numpy arrays."""
    bboxes, scores, labels = map(np.asarray, (bboxes, scores, labels))
    valid = np.asarray(valid).astype(bool)
    return [np.concatenate([bboxes[sel], scores[sel, None]], 1)
            .astype(np.float32)
            for sel in (valid & (labels == c) for c in range(num_classes))]


def clip_boxes(boxes: torch.Tensor, img_shape: torch.Tensor) -> torch.Tensor:
    """Clip ``(..., 4)`` boxes to an ``(h, w)`` image shape tensor whose
    leading dims broadcast against ``boxes[..., 0]``."""
    h = img_shape[..., 0]
    w = img_shape[..., 1]
    zero = torch.zeros_like(h)
    return torch.stack([
        torch.minimum(torch.maximum(boxes[..., 0], zero), w),
        torch.minimum(torch.maximum(boxes[..., 1], zero), h),
        torch.minimum(torch.maximum(boxes[..., 2], zero), w),
        torch.minimum(torch.maximum(boxes[..., 3], zero), h)], dim=-1)


def bbox_flip(boxes: torch.Tensor, img_shape,
              direction: str = 'horizontal') -> torch.Tensor:
    """Flip ``(..., 4)`` boxes inside an ``(h, w)`` image (JAX
    ``bbox_flip``, reference ``bbox/transforms.py:bbox_flip``):
    ``x1' = w - x2``, no ``- 1``. ``img_shape`` is the resized region,
    not the padded canvas; a tensor's leading dims broadcast against
    ``boxes[..., 0]``."""
    img_shape = torch.as_tensor(img_shape, dtype=boxes.dtype,
                                device=boxes.device)
    h, w = img_shape[..., 0], img_shape[..., 1]
    x1, y1, x2, y2 = boxes.unbind(-1)
    if direction == 'horizontal':
        return torch.stack([w - x2, y1, w - x1, y2], dim=-1)
    if direction == 'vertical':
        return torch.stack([x1, h - y2, x2, h - y1], dim=-1)
    raise ValueError(direction)


def bbox_mapping(boxes: torch.Tensor, img_shape, scale_factor, flip: bool,
                 direction: str = 'horizontal') -> torch.Tensor:
    """Original-image boxes -> an augmentation's frame: times the 4-vector
    ``scale_factor``, then flipped in the resized region."""
    boxes = boxes * torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                    device=boxes.device)
    return bbox_flip(boxes, img_shape, direction) if flip else boxes


def bbox_mapping_back(boxes: torch.Tensor, img_shape, scale_factor,
                      flip: bool, direction: str = 'horizontal'
                      ) -> torch.Tensor:
    """The inverse of :func:`bbox_mapping`: flipped back in the
    augmentation's frame, then divided by ``scale_factor``."""
    if flip:
        boxes = bbox_flip(boxes, img_shape, direction)
    return boxes / torch.as_tensor(scale_factor, dtype=boxes.dtype,
                                   device=boxes.device)
