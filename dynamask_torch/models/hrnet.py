"""HRNet backbone and HRFPN neck (port of ``dynamask_tpu/models/hrnet.py``).

HRNet: a stem of two 3x3 stride-2 convs (stride 4), ``layer1``'s
Bottlenecks, then stages 2-4 of ``HRModule``s over parallel branches at
strides 4/8/16/32. Before each stage a transition matches a branch's
channels (3x3 + BN + ReLU) or opens a new stride-2 branch from the last
one. A module runs each branch's ``BasicBlock``s, then fuses every pair:
from a coarser branch a 1x1 conv + BN and a nearest x2^(j-i) upsample,
from a finer one a chain of 3x3 stride-2 conv + BN (ReLU on every link but
the last), summed onto the branch in JAX's order (the branch first, then
the others by index) and put through a ReLU. ``frozen_stages``: 0 freezes
the stem, 1 and above the stem and ``layer1``, as JAX's
``frozen_param_paths`` (``stem_``, ``layer1_``) name them.

HRFPN: every branch upsampled bilinearly (``align_corners=False``) to
1/4, concatenated, reduced by a 1x1 conv with bias, average-pooled (floor
mode) into ``num_outs`` levels at strides 4 to 4 * 2^(num_outs - 1), and
each level through a 3x3 conv at ``stride`` (2: the FCOS recipe's strides
8-128). Its convs start He-normal over fan-out, as JAX's.

Module names are mmdet's: ``conv1``, ``bn1``, ``conv2``, ``bn2``;
``layer1.{b}``; ``transition{t}.{i}.{0,1}`` for a channel match and
``transition{t}.{i}.0.{0,1}`` for a new branch;
``stage{s}.{m}.branches.{b}.{k}``; ``stage{s}.{m}.fuse_layers.{i}.{j}.
{0,1}`` (j > i) and ``...{i}.{j}.{k}.{0,1}`` (j < i);
``neck.reduction_conv.conv``, ``neck.fpn_convs.{i}.conv``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import interpolate_bilinear
from ..utils.registry import BACKBONES, NECKS
from .layers import ConvModule
from .resnet import Backbone, BasicBlock, Bottleneck, Norm

# JAX's stages where ``extra`` names none (``hrnet.py:133-144``)
DEFAULT_STAGES = dict(
    stage1=dict(num_modules=1, num_branches=1, num_blocks=(4,),
                num_channels=(64,)),
    stage2=dict(num_modules=1, num_branches=2, num_blocks=(4, 4),
                num_channels=(32, 64)),
    stage3=dict(num_modules=4, num_branches=3, num_blocks=(4, 4, 4),
                num_channels=(32, 64, 128)),
    stage4=dict(num_modules=3, num_branches=4, num_blocks=(4, 4, 4, 4),
                num_channels=(32, 64, 128, 256)))


def conv_bn(cin: int, cout: int, k: int, stride: int, norm: Norm,
            relu: bool = True) -> nn.Sequential:
    layers = [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False),
              norm.make(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else \
        nn.Sequential(*layers)


class HRModule(nn.Module):
    """Branches of ``BasicBlock``s and their full pairwise fusion; takes
    and returns a list of the branches' maps."""

    def __init__(self, num_blocks: Sequence[int], channels: Sequence[int],
                 norm: Norm):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, c, norm=norm,
                                       zero_init_residual=False)
                            for _ in range(nb)])
            for nb, c in zip(num_blocks, channels)])
        if n == 1:
            return
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        *conv_bn(channels[j], channels[i], 1, 1, norm,
                                 relu=False),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode='nearest')))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        conv_bn(channels[j],
                                channels[i] if k == i - j - 1
                                else channels[j], 3, 2, norm,
                                relu=k != i - j - 1)
                        for k in range(i - j)]))
            self.fuse_layers.append(row)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if len(outs) == 1:
            return outs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = outs[i]
            for j, layer in enumerate(row):
                if j != i:
                    y = y + layer(outs[j])
            fused.append(F.relu(y))
        return fused


@BACKBONES.register_module()
class HRNet(Backbone):
    """HRNetV2p; ``extra`` in the config's schema (``stage{1..4}`` with
    ``num_modules``, ``num_branches``, ``num_blocks``, ``num_channels``;
    the blocks Bottleneck in stage 1 and BasicBlock after). Returns the
    four branches' maps (strides 4/8/16/32)."""

    def __init__(self, extra: Optional[dict] = None, norm_eval: bool = True,
                 frozen_stages: int = -1):
        super().__init__()
        extra = extra or {}
        stages = [dict(extra.get(f'stage{s}', DEFAULT_STAGES[f'stage{s}']))
                  for s in range(1, 5)]
        norm = Norm()
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = norm.make(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = norm.make(64)
        ch1 = stages[0]['num_channels'][0]
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if b == 0 else ch1 * 4, ch1, downsample=b == 0,
                       norm=norm, zero_init_residual=False)
            for b in range(stages[0]['num_blocks'][0])])
        prev = [ch1 * Bottleneck.expansion]
        for t, cfg in enumerate(stages[1:], 1):
            chans = tuple(cfg['num_channels'])
            trans = nn.ModuleList()
            for i in range(cfg['num_branches']):
                if i >= len(prev):
                    trans.append(nn.Sequential(
                        conv_bn(prev[-1], chans[i], 3, 2, norm)))
                elif prev[i] != chans[i]:
                    trans.append(conv_bn(prev[i], chans[i], 3, 1, norm))
                else:
                    trans.append(None)
            setattr(self, f'transition{t}', trans)
            setattr(self, f'stage{t + 1}', nn.Sequential(*[
                HRModule(tuple(cfg['num_blocks']), chans, norm)
                for _ in range(cfg['num_modules'])]))
            prev = list(chans)

    def frozen_modules(self):
        mods = [self.conv1, self.bn1, self.conv2, self.bn2] \
            if self.frozen_stages >= 0 else []
        return mods + ([self.layer1] if self.frozen_stages >= 1 else [])

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t in (1, 2, 3):
            trans = getattr(self, f'transition{t}')
            xs = [(xs[i] if layer is None else layer(xs[i])) if i < len(xs)
                  else layer(xs[-1]) for i, layer in enumerate(trans)]
            xs = getattr(self, f'stage{t + 1}')(xs)
        return tuple(xs)


@NECKS.register_module()
class HRFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 5, stride: int = 1):
        super().__init__()
        self.num_outs = num_outs
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1)
        self.fpn_convs = nn.ModuleList([
            ConvModule(out_channels, out_channels, 3, padding=1,
                       stride=stride) for _ in range(num_outs)])
        for m in (self.reduction_conv, *self.fpn_convs):
            m.conv.init_rule = 'he'

    def forward(self, inputs: Sequence[torch.Tensor]):
        outs = [inputs[0]]
        for i, x in enumerate(inputs[1:], 1):
            h, w = x.shape[-2:]
            outs.append(interpolate_bilinear(x, h * 2 ** i, w * 2 ** i,
                                             align_corners=False))
        x = self.reduction_conv(torch.cat(outs, 1))
        levels = [x] + [F.avg_pool2d(x, 2 ** i, 2 ** i)
                        for i in range(1, self.num_outs)]
        return tuple(conv(lvl) for conv, lvl in zip(self.fpn_convs, levels))
