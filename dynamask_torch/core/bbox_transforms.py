"""Box geometry on tensors (port of ``dynamask_tpu/core/bbox_transforms.py``).

Boxes are ``[x1, y1, x2, y2]``; padded slots travel with validity masks, as
in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

# dw/dh clamp ratio of the reference decoder (wh_ratio_clip=16/1000)
WH_RATIO_CLIP = 16.0 / 1000.0


def bbox_area(boxes: torch.Tensor) -> torch.Tensor:
    return ((boxes[..., 2] - boxes[..., 0]).clamp(min=0) *
            (boxes[..., 3] - boxes[..., 1]).clamp(min=0))


def bbox_overlaps(boxes1: torch.Tensor, boxes2: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Pairwise IoU of ``(..., N, 4)`` and ``(..., M, 4)`` -> ``(..., N, M)``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = bbox_area(boxes1)[..., :, None]
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
