"""FCN mask head, the fixed-28x28 Mask R-CNN baseline head (port of
``dynamask_tpu/models/fcn_mask_head.py:22-81``: ``FCNMaskHead``,
``select_class_channel`` and ``fcn_mask_loss``).

Four 3x3 convs with ReLU (bias-free, each with a GroupNorm, under
``norm='gn'``; ``num_convs`` of them, none in the C4 head, where the
transposed conv reads the shared head's ``in_channels``), a 2x2 stride-2
transposed conv (or, with ``upsample_type='carafe'``, a 2x
``CARAFEPack`` at JAX's defaults) with ReLU, and a 1x1 conv to one logit
map per class (one map when ``class_agnostic``); BCE on each positive
RoI's own class channel. The modules keep mmdet's names
(``convs.{i}.conv`` / ``.gn``, ``upsample``, ``conv_logits``), so the
reference's ``state_dict`` keys read as they are.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import HEADS
from .carafe import CARAFEPack
from .layers import ConvModule
from .losses import binary_cross_entropy_with_logits


@HEADS.register_module()
class FCNMaskHead(nn.Module):
    def __init__(self, num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 80,
                 class_agnostic: bool = False,
                 upsample_type: str = 'deconv', norm=None,
                 gn_groups: int = 32):
        super().__init__()
        if upsample_type not in ('deconv', 'carafe'):
            raise NotImplementedError(
                f'FCNMaskHead upsample_type={upsample_type!r}')
        if norm not in (None, 'gn'):
            raise NotImplementedError(f'FCNMaskHead norm={norm!r}')
        self.num_classes = num_classes
        self.class_agnostic = class_agnostic
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1,
                       gn_groups=gn_groups if norm else None)
            for i in range(num_convs))
        up_in = conv_out_channels if num_convs else in_channels
        self.upsample = (CARAFEPack(up_in, 2)
                         if upsample_type == 'carafe' else
                         nn.ConvTranspose2d(up_in, conv_out_channels, 2,
                                            stride=2))
        self.conv_logits = nn.Conv2d(conv_out_channels,
                                     1 if class_agnostic else num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, P, P) RoI features -> (N, num_classes, 2P, 2P) logits."""
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.conv_logits(F.relu(self.upsample(x)))


def select_class_channel(mask_logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W), (N,) -> (N, H, W): each RoI's class channel, the
    label clamped into range (a class-agnostic head has one channel)."""
    n, c = mask_logits.shape[:2]
    safe = labels.long().clamp(0, c - 1)
    return mask_logits[torch.arange(n, device=mask_logits.device), safe]


def fcn_mask_loss(mask_logits: torch.Tensor, mask_targets: torch.Tensor,
                  labels: torch.Tensor, pos_valid: torch.Tensor,
                  loss_weight: float = 1.0) -> torch.Tensor:
    """Mean BCE over the positive RoIs' pixels: each RoI's pixel mean,
    averaged over the valid RoIs (at least one)."""
    pred = select_class_channel(mask_logits, labels)
    per_roi = binary_cross_entropy_with_logits(pred, mask_targets).mean((1, 2))
    w = pos_valid.float()
    return loss_weight * (per_roi * w).sum() / w.sum().clamp(min=1.0)
