"""CARAFE's reassembly (port of ``dynamask_tpu/ops/carafe.py:27-45``): each
upsampled pixel is the sum of the ``up_kernel``² neighbourhood of its
source pixel, weighted by that pixel's normalised kernel. XLA in the JAX
package, not Pallas, so plain PyTorch here; a hand kernel comes only if it
wins on an H100 measurement. (JAX's ``masked_conv2d`` in the same file is
GA-RetinaNet's, not CARAFE's, and is not ported.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def carafe(x: torch.Tensor, masks: torch.Tensor, scale: int = 2,
           up_kernel: int = 5) -> torch.Tensor:
    """(B, C, H, W) features, (B, up_kernel², sH, sW) kernels -> (B, C, sH,
    sW) in the features' type, summed in fp32. Kernel channel ``i * k +
    j`` weighs the source pixel shifted by (i - k//2, j - k//2); pixels
    off the map add zero. No upsampled plane is stored: each shifted source
    plane meets its kernel channel as (H, 1, W, 1) against (H, s, W, s)."""
    b, c, h, w = x.shape
    k, r = up_kernel, up_kernel // 2
    xp = F.pad(x, (r, r, r, r))
    m = masks.float().reshape(b, 1, k * k, h, scale, w, scale)
    out = 0.0
    for i in range(k):
        for j in range(k):
            plane = xp[:, :, i:i + h, j:j + w].float()
            out = out + plane[:, :, :, None, :, None] * m[:, :, i * k + j]
    return out.reshape(b, c, h * scale, w * scale).to(x.dtype)
