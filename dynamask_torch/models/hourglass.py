"""CornerNet's HourglassNet (port of ``dynamask_tpu/models/hourglass.py:
26-135``): a stride-2 7x7 conv to 128 channels and a stride-2 BasicBlock
(the map at 1/4 of the image), then ``num_stacks`` recursive hourglass
modules, each ending in a 3x3 conv to ``feat_channel``, with 1x1 remaps
between stacks. One map per stack, at 1/4 of the image.

Each hourglass level adds its ``up1`` branch to the nearest 2x upsample
(``repeat`` twice, as in JAX) of its ``low1 -> low2 -> low3`` branch, so
the level's map must halve evenly: JAX's sum fails where it does not (the
stride-4 map at 86 rows halves to 43, then 22, which upsamples to 44).
The port raises a ``ValueError`` there naming both shapes (ROADMAP.md
queue 3, 3bq); it never pads.

``low3``'s residual layer puts its channel change in its last block
(mmdet's ``downsample_first=False``): the blocks before it keep the input
width. JAX builds every block of that layer at the output width, so it
cannot add a block's output to its identity wherever a stage of two or
more blocks changes the width (the config's Hourglass-104 at its second
level: 384 channels into 256), and its HourglassNet does not run the
config; where it runs (one block a stage, or no change) the two are one
function (3bv).

Module names follow mmdet (``stem.0.conv``, ``stem.1.0.conv1``,
``hourglass_modules.{i}.{up1,low1,low2,low3}...``, ``out_convs.{i}``,
``conv1x1s.{i}``, ``remap_convs.{i}``, ``inters.{i}``). BatchNorms train
on batch statistics (``norm_eval`` is False in JAX's hourglass), their
running variance updated with the biased batch variance as flax's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2dBiasedVar
from .resnet import Backbone, BasicBlock, Norm


class _FlaxNorm(Norm):
    """BatchNorm at eps 1e-5 updating its running variance as flax's."""

    def __init__(self):
        super().__init__(None)

    def make(self, c: int, zero_init: bool = False) -> nn.Module:
        norm = BatchNorm2dBiasedVar(c, eps=1e-5)
        norm.zero_init = zero_init
        return norm


class ConvBN(nn.Module):
    """mmcv's ``ConvModule`` with BN: a bias-free conv ``.conv``, ``.bn``,
    a ReLU with ``act``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, (kernel - 1) // 2,
                              bias=False)
        self.bn = BatchNorm2dBiasedVar(cout, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


def res_layer(inplanes: int, planes: int, num_blocks: int, stride: int = 1,
              downsample_first: bool = True) -> nn.Sequential:
    """BasicBlocks, the stride and channel change in the first
    (``downsample_first``) or the last block, which projects where it
    changes either."""
    change = stride != 1 or inplanes != planes
    blocks = []
    for i in range(num_blocks):
        first, last = i == 0, i == num_blocks - 1
        if downsample_first:
            cin, cout = (inplanes, planes) if first else (planes, planes)
            s, proj = (stride, change) if first else (1, False)
        else:
            cin, cout = (inplanes, planes) if last else (inplanes, inplanes)
            s, proj = (stride, change) if last else (1, False)
        blocks.append(BasicBlock(cin, cout, s, downsample=proj,
                                 norm=_FlaxNorm(),
                                 zero_init_residual=False))
    return nn.Sequential(*blocks)


class HourglassModule(nn.Module):
    def __init__(self, depth: int, stage_channels: Sequence[int],
                 stage_blocks: Sequence[int]):
        super().__init__()
        cur_c, next_c = stage_channels[0], stage_channels[1]
        cur_b, next_b = stage_blocks[0], stage_blocks[1]
        self.up1 = res_layer(cur_c, cur_c, cur_b)
        self.low1 = res_layer(cur_c, next_c, cur_b, stride=2)
        self.low2 = (HourglassModule(depth - 1, stage_channels[1:],
                                     stage_blocks[1:]) if depth > 1 else
                     res_layer(next_c, next_c, next_b))
        self.low3 = res_layer(next_c, cur_c, cur_b, downsample_first=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.up1(x)
        low3 = self.low3(self.low2(self.low1(x)))
        up2 = low3.repeat_interleave(2, 2).repeat_interleave(2, 3)
        if up2.shape[-2:] != up1.shape[-2:]:
            raise ValueError(
                f'HourglassNet: a {tuple(x.shape[-2:])} level upsamples its '
                f'halved branch to {tuple(up2.shape[-2:])}, not '
                f'{tuple(up1.shape[-2:])}: the stride-4 map must halve '
                'evenly downsample_times times (ROADMAP.md queue 3, 3bq: '
                'the JAX package\'s sum fails there)')
        return up1 + up2


class HourglassNet(Backbone):
    """Returns one (B, feat_channel, H/4, W/4) map a stack."""

    norm_eval = False

    def __init__(self, downsample_times: int = 5, num_stacks: int = 2,
                 stage_channels: Sequence[int] = (256, 256, 384, 384, 384,
                                                  512),
                 stage_blocks: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 feat_channel: int = 256):
        super().__init__()
        if len(stage_channels) != len(stage_blocks) or \
                len(stage_channels) <= downsample_times:
            raise ValueError(f'HourglassNet: {downsample_times} '
                             f'downsamplings over {len(stage_channels)} '
                             'stages')
        cur_c = stage_channels[0]
        self.num_stacks = num_stacks
        self.stem = nn.Sequential(ConvBN(3, 128, 7, stride=2),
                                  res_layer(128, cur_c, 1, stride=2))
        self.hourglass_modules = nn.ModuleList(
            HourglassModule(downsample_times, stage_channels, stage_blocks)
            for _ in range(num_stacks))
        self.out_convs = nn.ModuleList(
            ConvBN(cur_c, feat_channel, 3) for _ in range(num_stacks))
        self.conv1x1s = nn.ModuleList(
            ConvBN(cur_c, cur_c, 1, act=False)
            for _ in range(num_stacks - 1))
        self.remap_convs = nn.ModuleList(
            ConvBN(feat_channel, cur_c, 1, act=False)
            for _ in range(num_stacks - 1))
        self.inters = res_layer(cur_c, cur_c, num_stacks - 1)

    def forward(self, x: torch.Tensor):
        inter = self.stem(x)
        outs = []
        for i in range(self.num_stacks):
            out = self.out_convs[i](self.hourglass_modules[i](inter))
            outs.append(out)
            if i < self.num_stacks - 1:
                inter = self.conv1x1s[i](inter) + self.remap_convs[i](out)
                inter = self.inters[i](F.relu(inter))
        return outs
