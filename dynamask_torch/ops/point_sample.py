"""Point sampling of feature maps (port of ``dynamask_tpu/ops/
point_sample.py``: ``rel_roi_points_to_img_points`` :14 and
``point_sample`` :30), and the top-k the point heads rank with.

Plain gather and lerp, as XLA computes it in the JAX package (no Pallas
kernel there, no hand kernel here): four corner gathers of a flat NHWC
buffer, each zero outside the map, with grid_sample's -0.5 centre offset.
The backward is autograd's scatter-add into the gathered rows.

:func:`top_k` is ``jax.lax.top_k``'s order: the largest values first and,
among equal values, the lower index first. ``torch.topk`` promises no
order among ties (ROADMAP.md queue 3), and the point heads rank maps with
many: a padded detection slot or a ReLU-zero crop gives every position the
same logit.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the ``k`` largest entries of the last axis,
    ties to the lower index (a stable descending sort)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def rel_roi_points_to_img_points(rois: torch.Tensor, rel_points: torch.Tensor,
                                 spatial_scale: float) -> torch.Tensor:
    """Per-RoI relative points (R, P, 2) as (x, y) fractions of the RoI
    (R, 4) -> (R, P, 2) (x, y) coordinates on a map of ``spatial_scale``."""
    x1, y1 = rois[:, 0:1], rois[:, 1:2]
    w = (rois[:, 2] - rois[:, 0])[:, None]
    h = (rois[:, 3] - rois[:, 1])[:, None]
    xs = (x1 + rel_points[..., 0] * w) * spatial_scale
    ys = (y1 + rel_points[..., 1] * h) * spatial_scale
    return torch.stack([xs, ys], -1)


def point_sample(features: torch.Tensor, points_xy: torch.Tensor,
                 point_batch: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of NHWC ``features`` (B, H, W, C) at the map
    coordinates ``points_xy`` (R, P, 2) of image ``point_batch`` (R,) ->
    (R, P, C); ``F.grid_sample(align_corners=False)``'s convention (a
    sample at x reads pixel centres x - 0.5), zero outside the map."""
    b, h, w, c = features.shape
    flat = features.reshape(b * h * w, c)
    xs = points_xy[..., 0] - 0.5
    ys = points_xy[..., 1] - 0.5
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    ly = ys - y0
    lx = xs - x0
    base = (point_batch.long() * (h * w))[:, None]
    dt = features.dtype

    def corner(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        idx = (base + yc * w + xc).reshape(-1)
        vals = flat.index_select(0, idx).reshape(*yi.shape, c)
        return vals * inb[..., None].to(dt)

    return (corner(y0, x0) * ((1 - ly) * (1 - lx))[..., None].to(dt) +
            corner(y0, x0 + 1) * ((1 - ly) * lx)[..., None].to(dt) +
            corner(y0 + 1, x0) * (ly * (1 - lx))[..., None].to(dt) +
            corner(y0 + 1, x0 + 1) * (ly * lx)[..., None].to(dt))
