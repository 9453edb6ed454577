"""Feature Pyramid Network (port of ``dynamask_tpu/models/fpn.py``): 1×1
laterals, nearest ×2 top-down adds, 3×3 output convs, and extra levels by
stride-2 max pool (``num_outs=5`` gives P6). The JAX form bands the big
levels' convs across W (``conv_space_to_batch_w``, a TPU layout rewrite); the
port runs the plain convs.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import NECKS
from .layers import ConvModule


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5):
        super().__init__()
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1)
             for _ in in_channels])

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode='nearest')
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(outs[-1][:, :, ::2, ::2])   # max_pool(1, stride 2)
        return tuple(outs)
