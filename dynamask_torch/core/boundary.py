"""Boundary block targets, detail targets and bilinear resize (port of
``generate_block_target``, ``detail_target`` (:85-117) and
``interpolate_bilinear`` in ``dynamask_tpu/core/boundary.py``)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _laplacian_conv(x: torch.Tensor, boundary_width: int,
                    padding: int, stride: int = 1) -> torch.Tensor:
    """Conv of ``(N, H, W)`` maps with the all -1 / centre k²-1 kernel,
    written as k²·centre − box sum."""
    k = 2 * boundary_width + 1
    x = x.float()
    n, h, w = x.shape
    xp = F.pad(x, (padding,) * 4)
    oh = (h + 2 * padding - k) // stride + 1
    ow = (w + 2 * padding - k) // stride + 1
    ey, ex = (oh - 1) * stride + 1, (ow - 1) * stride + 1
    box = None
    for i in range(k):
        for j in range(k):
            sl = xp[:, i:i + ey:stride, j:j + ex:stride]
            box = sl if box is None else box + sl
    bw = boundary_width
    center = xp[:, bw:bw + ey:stride, bw:bw + ex:stride]
    return (k * k) * center - box


def generate_block_target(mask: torch.Tensor,
                          boundary_width: int = 3) -> torch.Tensor:
    """``(N, H, W)`` binary masks -> int32 block map: 0 background,
    1 boundary, 2 interior. The complement is taken of the zero-padded mask,
    so its padding ring is 1 (as in the reference)."""
    mask = mask.float()
    k = 2 * boundary_width + 1
    bw = boundary_width
    pos = _laplacian_conv(mask, bw, padding=bw).clamp(min=0.0) / float(k * k)
    pos = (pos > 0.1).float()
    comp = 1.0 - F.pad(mask, (bw,) * 4)
    neg = _laplacian_conv(comp, bw, padding=0).clamp(min=0.0) / float(k * k)
    neg = (neg > 0.1).float()
    block = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    block = torch.where((pos + neg) > 0, 1, block)
    block = torch.where((mask - pos) > 0, 2, block)
    return block.to(torch.int32)


def detail_target(gt_masks: torch.Tensor,
                  fuse_weights: torch.Tensor) -> torch.Tensor:
    """``(N, H, W)`` binary masks -> ``(N, H, W)`` binary boundary targets:
    3×3 Laplacian at stride 1 and at stride 2 (nearest ×2 back), each
    binarised at 0.1, fused by the two ``fuse_weights``, binarised at 0.1.
    The thresholds pass no gradient to the fuse weights."""
    m = gt_masks.float()
    h, w = m.shape[-2:]
    b1 = (_laplacian_conv(m, 1, padding=1).clamp(min=0.0) > 0.1).float()
    b2 = _laplacian_conv(m, 1, padding=1, stride=2).clamp(min=0.0)
    b2 = b2.repeat_interleave(2, 1).repeat_interleave(2, 2)[:, :h, :w]
    b2 = (b2 > 0.1).float()
    fw = fuse_weights.reshape(-1)
    return (fw[0] * b1 + fw[1] * b2 > 0.1).float()


@functools.lru_cache(maxsize=64)
def _interp_matrix(out_size: int, in_size: int,
                   align_corners: bool) -> np.ndarray:
    """``(out, in)`` dense bilinear interpolation matrix (float32)."""
    if align_corners:
        coords = (np.zeros(1, np.float64) if out_size == 1 else
                  np.linspace(0.0, in_size - 1.0, out_size))
    else:
        coords = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
        coords = np.clip(coords, 0, in_size - 1)
    c0 = np.clip(np.floor(coords), 0, in_size - 1).astype(np.int64)
    c1 = np.minimum(c0 + 1, in_size - 1)
    frac = coords - c0
    m = np.zeros((out_size, in_size), np.float32)
    m[np.arange(out_size), c0] += 1.0 - frac
    m[np.arange(out_size), c1] += frac
    m.flags.writeable = False
    return m


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of ``(..., H, W)`` with ``F.interpolate`` semantics,
    as two matmuls against constant interpolation matrices. A bf16 ``x``
    goes as in the JAX package: the matrices and the first product rounded
    to bf16, each product summed in fp32, the result bf16."""
    h, w = x.shape[-2], x.shape[-1]
    dt = x.dtype if x.dtype == torch.bfloat16 else torch.float32
    # bf16 operands are exact in fp32: their fp32 products are the bf16
    # products summed in fp32
    a = torch.tensor(_interp_matrix(out_h, h, align_corners),
                     device=x.device).to(dt).float()
    bt = torch.tensor(_interp_matrix(out_w, w, align_corners),
                      device=x.device).t().to(dt).float()
    y = torch.matmul(a, x.float()).to(dt).float()
    return torch.matmul(y, bt).to(x.dtype)
