"""Mask targets of the positive RoIs from per-GT crops (port of
``mask_targets_from_crops`` in ``dynamask_tpu/core/mask_targets.py:28-90``,
with ``_sample_coords`` and ``tent_matrix`` of
``dynamask_tpu/ops/roi_align.py`` :131 and :344).

Each GT instance ships as a fixed-size ``(S, S)`` crop of its mask over an
image-space ``window``. A RoI's target is an aligned RoIAlign of its GT's
crop, written as two tent-weight matmuls per RoI (``A_y @ plane @ A_x^T``),
binarised at 0.5. Plain matmuls, as in the JAX package: no kernel.
"""

from __future__ import annotations

import torch


def _sample_coords(rois: torch.Tensor, out_size: int, sampling_ratio: int):
    """Aligned sample coordinates per RoI and axis, (N, out * s) each."""
    dev = rois.device
    x1, y1 = rois[:, 0] - 0.5, rois[:, 1] - 0.5
    x2, y2 = rois[:, 2] - 0.5, rois[:, 3] - 0.5
    s = sampling_ratio
    sub = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev)[:, None]
            + sub[None, :]).reshape(-1)
    # a tensor divisor keeps the division exact, as XLA's
    div = torch.full_like(x1, float(out_size))
    ys = y1[:, None] + ((y2 - y1) / div)[:, None] * grid[None, :]
    xs = x1[:, None] + ((x2 - x1) / div)[:, None] * grid[None, :]
    return ys, xs


def tent_matrix(coords: torch.Tensor, extent: int, out_size: int,
                s: int) -> torch.Tensor:
    """(N, P*s) sample coordinates -> (N, P, extent) sub-sample-averaged
    bilinear weights; mmcv's rule: the inside test on the raw coordinate,
    then a clamp to the plane."""
    n = coords.shape[0]
    inside = ((coords >= -1.0) & (coords <= extent))[..., None]
    cl = coords.clamp(0.0, extent - 1)
    r = torch.arange(extent, dtype=torch.float32, device=coords.device)
    t = (1.0 - (cl[:, :, None] - r).abs()).clamp(min=0.0)
    t = torch.where(inside, t, 0.0)
    return t.reshape(n, out_size, s, extent).mean(2)


def mask_targets_from_crops(gt_crops: torch.Tensor, gt_windows: torch.Tensor,
                            rois: torch.Tensor, roi_batch: torch.Tensor,
                            roi_gt: torch.Tensor, img_hw: torch.Tensor,
                            out_size: int,
                            sampling_ratio: int = 2) -> torch.Tensor:
    """``gt_crops`` (B, G, S, S), ``gt_windows`` (B, G, 4) xyxy, ``rois``
    (R, 4) image coordinates, ``roi_batch`` / ``roi_gt`` (R,), ``img_hw``
    (B, 2) -> (R, out_size, out_size) float32 binary targets. RoIs are
    clipped to the image and carry no gradient."""
    rois = rois.detach().float()
    b, g, s, _ = gt_crops.shape
    flat_gt = roi_batch.long() * g + roi_gt.long()
    win = gt_windows.reshape(b * g, 4).float()[flat_gt]
    hw = img_hw.float()[roi_batch.long()]
    x1 = torch.minimum(rois[:, 0].clamp(min=0), hw[:, 1])
    y1 = torch.minimum(rois[:, 1].clamp(min=0), hw[:, 0])
    x2 = torch.minimum(rois[:, 2].clamp(min=0), hw[:, 1])
    y2 = torch.minimum(rois[:, 3].clamp(min=0), hw[:, 0])
    # a tensor numerator: ``s / t`` would be s * (1 / t), not XLA's exact
    # division
    full = torch.full_like(win[:, 0], float(s))
    sx = full / (win[:, 2] - win[:, 0]).clamp(min=1e-6)
    sy = full / (win[:, 3] - win[:, 1]).clamp(min=1e-6)
    crop_rois = torch.stack([(x1 - win[:, 0]) * sx, (y1 - win[:, 1]) * sy,
                             (x2 - win[:, 0]) * sx, (y2 - win[:, 1]) * sy],
                            -1)
    planes = gt_crops.reshape(b * g, s, s).float()[flat_gt]
    ys, xs = _sample_coords(crop_rois, out_size, sampling_ratio)
    a_y = tent_matrix(ys, s, out_size, sampling_ratio)
    a_x = tent_matrix(xs, s, out_size, sampling_ratio)
    out = torch.matmul(torch.matmul(a_y, planes), a_x.transpose(1, 2))
    return (out >= 0.5).float()
