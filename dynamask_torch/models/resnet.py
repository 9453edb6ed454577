"""ResNet backbone (port of ``dynamask_tpu/models/resnet.py``): depths 18
and 34 (BasicBlock), 50, 101 and 152 (Bottleneck), 'pytorch' style (stride
on the 3×3), eval-mode BatchNorm with eps 1e-5. Module names follow torchvision/mmdet so
the state dict reads ``backbone.layer1.0.conv1.weight``.

The JAX stem is ``S2DStemConv`` (``resnet.py:45``), an exact TPU layout
rewrite of the 7×7 stride-2 conv; the port runs the plain conv.
In training (the JAX package's ``resnet.py:197,243,321,347-388``):
``frozen_stages = n`` freezes the stem and the first n stages (no gradient,
no update, no weight decay: their parameters stop requiring a gradient), and
``norm_eval`` keeps every BatchNorm on its running statistics when the model
is put in training mode.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import BACKBONES


def _bn(c: int, zero_init: bool = False) -> nn.BatchNorm2d:
    """``zero_init``: the block's last BN, whose scale starts at 0
    (``zero_init_residual``, the JAX package's and mmdet's default), so
    that each residual block starts as the identity."""
    bn = nn.BatchNorm2d(c, eps=1e-5)
    bn.zero_init = zero_init
    return bn


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = _bn(planes, zero_init=True)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes, 1, stride, bias=False), _bn(planes))
            if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = _bn(planes * 4, zero_init=True)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, planes * 4, 1, stride, bias=False),
            _bn(planes * 4)) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


# the JAX package's table (``dynamask_tpu/models/resnet.py:276-282``)
ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """Returns the stage outputs of ``out_indices`` (strides 4/8/16/32)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 style: str = 'pytorch'):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'ResNet depth {depth} is not ported')
        if style != 'pytorch':
            raise NotImplementedError(f'ResNet style {style!r}')
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        inplanes, planes = 64, 64
        self.num_stages = num_stages
        for i, n in enumerate(stage_blocks[:num_stages]):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n):
                first = b == 0
                # Bottleneck stages always project in their first block;
                # BasicBlock stages only where the shape changes
                proj = first and (block is Bottleneck or i > 0)
                blocks.append(block(inplanes, planes, stride if first else 1,
                                    downsample=proj))
                inplanes = planes * block.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            planes *= 2

    def frozen_modules(self):
        """The stem and the first ``frozen_stages`` stages."""
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [
            getattr(self, f'layer{i}') for i in range(1, self.frozen_stages
                                                      + 1)]

    def freeze_stages(self) -> None:
        for m in self.frozen_modules():
            for p in m.parameters():
                p.requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
