"""Device-side mask pasting (port of ``dynamask_tpu/ops/paste.py:72``).

Each RoI's P×P mask is resampled into its box on a static canvas with
``grid_sample(align_corners=False)`` semantics and zero padding, written as
two batched matmuls against per-RoI bilinear axis matrices. bf16 masks stay
bf16 at the products' inputs, the axis weights rounded to bf16 with them,
and the products sum in fp32, as in the JAX package
(``dynamask_tpu/ops/paste.py:64-68``).
"""

from __future__ import annotations

import torch


def _axis_weights(coord: torch.Tensor, size: int) -> torch.Tensor:
    """(N, out) source coordinates -> (N, out, size) two-tap bilinear rows;
    out-of-range taps weigh 0."""
    c0 = torch.floor(coord)
    frac = coord - c0
    c0i = c0.long()
    c1i = c0i + 1
    w0 = torch.where((c0i >= 0) & (c0i < size), 1.0 - frac,
                     torch.zeros_like(frac))
    w1 = torch.where((c1i >= 0) & (c1i < size), frac, torch.zeros_like(frac))
    cols = torch.arange(size, device=coord.device)
    return (w0[..., None] * (cols == c0i[..., None]) +
            w1[..., None] * (cols == c1i[..., None]))


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, out_h: int,
                out_w: int) -> torch.Tensor:
    """Paste (N, P, P) masks into (N, out_h, out_w) canvases at ``boxes``
    (N, 4) in canvas coordinates; the caller thresholds."""
    n, ph, pw = masks.shape
    x0, y0, x1, y1 = boxes.float().unbind(-1)
    dev = masks.device
    img_y = torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5
    img_x = torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5
    gy = (img_y[None, :] - y0[:, None]) / \
        (y1 - y0).clamp(min=1e-6)[:, None] * 2 - 1
    gx = (img_x[None, :] - x0[:, None]) / \
        (x1 - x0).clamp(min=1e-6)[:, None] * 2 - 1
    my = ((gy + 1.0) * ph - 1.0) * 0.5
    mx = ((gx + 1.0) * pw - 1.0) * 0.5
    wy = _axis_weights(my, ph)                       # (N, out_h, ph)
    wx = _axis_weights(mx, pw)                       # (N, out_w, pw)
    # bf16 operands are exact in fp32: the fp32 products of their widened
    # values are the bf16 products summed in fp32
    dt = masks.dtype if masks.dtype == torch.bfloat16 else torch.float32
    wy, wx = wy.to(dt).float(), wx.to(dt).float()
    tmp = torch.bmm(wy, masks.float())               # (N, out_h, pw)
    return torch.bmm(tmp, wx.transpose(1, 2))        # (N, out_h, out_w)
