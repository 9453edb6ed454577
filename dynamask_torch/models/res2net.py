"""Res2Net backbone (port of ``dynamask_tpu/models/res2net.py``): the
deep stem of three 3x3 convs, then stages of ``Bottle2neck`` blocks whose
1x1 output splits into ``scales`` groups of ``width`` channels, each but
the last through its own 3x3 (in a stage's first block each group alone;
in the others each after adding the previous group's output), the last
passed on (pooled in a strided first block), and the avg-down projection
(an average pool, then a stride-1 1x1 + BN).

Both pools are JAX's ``_avg_pool`` (``:23-39``): ceil mode, windows
padded on the right and bottom, averaged over the real pixels only. In a
stage's first block the last group is pooled 3x3 at stride 2 so (ceil
mode, no left padding); mmdet v2's ``Bottle2neck`` pools it with
``AvgPool2d(3, stride, padding=1)``, padding counted, its windows lined
up with the strided 3x3 convs'. The port computes JAX's pool (ROADMAP.md
queue 3, 3ai).

Module names are mmdet's: ``stem.{0,1,3,4,6,7}``; ``layer{s}.{b}.conv1``,
``bn1``, ``convs.{i}``, ``bns.{i}``, ``conv3``, ``bn3``;
``downsample.{1,2}`` (0 is the pool).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import BACKBONES
from .resnet import ARCH_SETTINGS, Backbone, Bottleneck, Norm, _Block
from .resnet import deep_stem_layers


def ceil_avg_pool(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """JAX's ``_avg_pool``: output size max(ceil((n - k) / s) + 1, 1), the
    windows past the right or bottom edge averaging the pixels they
    cover."""
    def pad_for(n):
        out = max(-(-(n - k) // s) + 1, 1)
        return max((out - 1) * s + k - n, 0)
    pad = (0, pad_for(x.shape[-1]), 0, pad_for(x.shape[-2]))
    num = F.avg_pool2d(F.pad(x, pad), k, s, divisor_override=1)
    ones = F.pad(torch.ones_like(x[:, :1]), pad)
    den = F.avg_pool2d(ones, k, s, divisor_override=1)
    return num / den.clamp_min(1e-6)


class CeilAvgPool(nn.Module):
    """:func:`ceil_avg_pool` as a module (mmdet's ``downsample.0``); at
    stride 1 the identity, as JAX skips it."""

    def __init__(self, stride: int):
        super().__init__()
        self.stride = stride

    def forward(self, x):
        return x if self.stride == 1 else ceil_avg_pool(x, self.stride,
                                                        self.stride)


class Bottle2neck(_Block):
    """Output channels ``planes * 4``; ``stage_type='stage'`` for a
    stage's first block."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, scales: int = 4,
                 base_width: int = 26, base_channels: int = 64,
                 stage_type: str = 'normal', norm: Optional[Norm] = None,
                 zero_init_residual: bool = True):
        super().__init__()
        norm = norm or Norm()
        width = int(planes * base_width / base_channels)
        self.scales, self.stride, self.stage_type = scales, stride, stage_type
        self.conv1 = nn.Conv2d(inplanes, width * scales, 1, bias=False)
        self.bn1 = norm.make(width * scales)
        self.convs = nn.ModuleList([
            nn.Conv2d(width, width, 3, stride, 1, bias=False)
            for _ in range(scales - 1)])
        self.bns = nn.ModuleList([norm.make(width)
                                  for _ in range(scales - 1)])
        self.conv3 = nn.Conv2d(width * scales, planes * 4, 1, bias=False)
        self.bn3 = norm.make(planes * 4, zero_init_residual)
        self.downsample = nn.Sequential(
            CeilAvgPool(stride),
            nn.Conv2d(inplanes, planes * 4, 1, bias=False),
            norm.make(planes * 4)) if downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        spx = torch.chunk(out, self.scales, 1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            inp = spx[i] if (self.stage_type == 'stage' or i == 0) \
                else sp + spx[i]
            sp = F.relu(bn(conv(inp)))
            outs.append(sp)
        last = spx[-1]
        if self.stage_type == 'stage' and self.stride != 1:
            last = ceil_avg_pool(last, 3, self.stride)
        out = self.bn3(self.conv3(torch.cat(outs + [last], 1)))
        return F.relu(out + identity)


@BACKBONES.register_module()
class Res2Net(Backbone):
    """The v1d layout of every released Res2Net (the deep stem and the
    avg-down projections); depth 50, 101 or 152. ``frozen_stages = n``
    freezes the stem and the first n stages (JAX ``frozen_param_paths``:
    ``stem_conv*``, ``stem_bn*``, ``layer{s}_``)."""

    def __init__(self, depth: int = 101, scales: int = 4,
                 base_width: int = 26, num_stages: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 zero_init_residual: bool = True, stem_channels: int = 64):
        super().__init__()
        block, stage_blocks = ARCH_SETTINGS[depth]
        if block is not Bottleneck:
            raise KeyError(f'Res2Net depth {depth}: it needs depth >= 50')
        norm = Norm()
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.num_stages = num_stages
        self.stem = deep_stem_layers(norm, stem_channels)
        inplanes, planes = stem_channels, 64
        for i, n in enumerate(stage_blocks[:num_stages]):
            stride = 1 if i == 0 else 2
            setattr(self, f'layer{i + 1}', nn.Sequential(*[
                Bottle2neck(inplanes if b == 0 else planes * 4, planes,
                            stride if b == 0 else 1, downsample=b == 0,
                            scales=scales, base_width=base_width,
                            stage_type='stage' if b == 0 else 'normal',
                            norm=norm, zero_init_residual=zero_init_residual)
                for b in range(n)]))
            inplanes = planes * 4
            planes *= 2

    def frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.stem] + [getattr(self, f'layer{i}')
                              for i in range(1, self.frozen_stages + 1)]

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
