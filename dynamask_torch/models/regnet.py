"""RegNet backbone (port of ``dynamask_tpu/models/regnet.py``): per-block
widths from the quantized linear rule, collapsed into four stages of
grouped bottlenecks (expansion 1, ``bot_mul`` bottleneck ratio) after a
3x3 stride-2 stem of 32 channels, each stage's first block strided and
projected.

The layout functions are JAX's (``:41-72``), run on plain numpy, so every
arch gives JAX's widths, depths and group counts. JAX passes the adjusted
*group width* as the conv's group *count* (``:181-182, :140``; mmdet
divides the width by it): the port computes JAX's function, 48 groups of
2 channels where mmdet has 2 groups of 48 in ``regnetx_3.2gf``'s first
stage (ROADMAP.md queue 3, 3ag). An mmdet checkpoint's ``conv2.weight``
therefore does not fit, and a load of one is refused naming 3ag
(:meth:`RegNet.weight_fault`); it is never reshaped.

Module names are mmdet's (a ResNet's: ``conv1``, ``bn1``,
``layer{s}.{b}.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample.{0,1}``).
With ``dcn`` (the mdconv config) the 3x3 of the ``stage_with_dcn`` stages
is a deformable conv through the exact gather at any map shape, DCNv2 by
default (JAX ``:86-120``), its grouped ``conv2.weight`` (3ag's groups)
contracted as the block-diagonal dense kernel JAX assembles.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import BACKBONES
from .layers import DeformConv2dPack
from .resnet import Backbone, Norm, _Block

# the JAX package's table (``dynamask_tpu/models/regnet.py:22-39``)
ARCH_SETTINGS: Dict[str, dict] = {
    'regnetx_400mf': dict(w0=24, wa=24.48, wm=2.54, group_w=16, depth=22,
                          bot_mul=1.0),
    'regnetx_800mf': dict(w0=56, wa=35.73, wm=2.28, group_w=16, depth=16,
                          bot_mul=1.0),
    'regnetx_1.6gf': dict(w0=80, wa=34.01, wm=2.25, group_w=24, depth=18,
                          bot_mul=1.0),
    'regnetx_3.2gf': dict(w0=88, wa=26.31, wm=2.25, group_w=48, depth=25,
                          bot_mul=1.0),
    'regnetx_4.0gf': dict(w0=96, wa=38.65, wm=2.43, group_w=40, depth=23,
                          bot_mul=1.0),
    'regnetx_6.4gf': dict(w0=184, wa=60.83, wm=2.07, group_w=56, depth=17,
                          bot_mul=1.0),
    'regnetx_8.0gf': dict(w0=80, wa=49.56, wm=2.88, group_w=120, depth=23,
                          bot_mul=1.0),
    'regnetx_12gf': dict(w0=168, wa=73.36, wm=2.37, group_w=112, depth=19,
                         bot_mul=1.0),
}
FAULT = 'ROADMAP.md queue 3, 3ag'


def generate_regnet(w0, wa, wm, depth, divisor=8):
    """Per-block widths from the quantized linear rule, and the number of
    distinct widths."""
    widths_cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / divisor) * divisor).astype(int)
    return widths.tolist(), len(np.unique(widths))


def quantize_float(number, divisor):
    return int(round(number / divisor) * divisor)


def adjust_width_group(widths, bottleneck_ratio, groups):
    """Widths made divisible by the (adjusted) group values."""
    bw = [int(w * b) for w, b in zip(widths, bottleneck_ratio)]
    groups = [min(g, w) for g, w in zip(groups, bw)]
    bw = [quantize_float(w, g) for w, g in zip(bw, groups)]
    widths = [int(w / b) for w, b in zip(bw, bottleneck_ratio)]
    return widths, groups


def get_stages_from_blocks(widths):
    """Equal-width runs collapsed into (stage widths, stage blocks)."""
    diff = [w != wp for w, wp in zip(widths + [0], [0] + widths)]
    stage_widths = [w for w, d in zip(widths, diff[:-1]) if d]
    stage_blocks = np.diff([i for i, d in enumerate(diff) if d]).tolist()
    return stage_widths, stage_blocks


def regnet_layout(arch) -> Tuple[list, list, list, list]:
    """(stage widths, stage blocks, bottleneck ratios, group counts as JAX
    takes them) of an ``ARCH_SETTINGS`` name or an arch dict (JAX
    ``RegNet._layout``)."""
    arch = ARCH_SETTINGS[arch] if isinstance(arch, str) else dict(arch)
    widths, _ = generate_regnet(arch['w0'], arch['wa'], arch['wm'],
                                arch['depth'])
    stage_widths, stage_blocks = get_stages_from_blocks(widths)
    bot_muls = [arch['bot_mul']] * len(stage_widths)
    group_ws = [arch['group_w']] * len(stage_widths)
    stage_widths, groups = adjust_width_group(stage_widths, bot_muls,
                                              group_ws)
    return stage_widths, stage_blocks, bot_muls, groups


class RegNetBlock(_Block):
    """Grouped bottleneck: 1x1 to the bottleneck width, 3x3 at ``stride``
    in ``groups`` groups, 1x1 back to ``width``; BN after each, ReLU but
    after the last; the projection (stride-s 1x1 + BN) given
    ``downsample``."""

    def __init__(self, inplanes: int, width: int, bottleneck_width: int,
                 groups: int, stride: int = 1, downsample: bool = False,
                 norm: Optional[Norm] = None, dcn: Optional[dict] = None):
        super().__init__()
        norm = norm or Norm()
        bw = bottleneck_width
        self.conv1 = nn.Conv2d(inplanes, bw, 1, bias=False)
        self.bn1 = norm.make(bw)
        self.conv2 = (DeformConv2dPack(bw, bw, stride, groups=groups, **dcn)
                      if dcn else nn.Conv2d(bw, bw, 3, stride, 1,
                                            groups=groups, bias=False))
        self.bn2 = norm.make(bw)
        self.conv3 = nn.Conv2d(bw, width, 1, bias=False)
        self.bn3 = norm.make(width)
        self.downsample = (self._projection(inplanes, width, stride, norm)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


@BACKBONES.register_module()
class RegNet(Backbone):
    """``arch`` is a name of ``ARCH_SETTINGS`` or a dict of its keys;
    returns the stage outputs of ``out_indices`` (strides 4/8/16/32 at the
    default ``strides``). ``frozen_stages = n`` freezes the stem and the
    first n stages (JAX ``frozen_param_paths``: ``conv1``, ``bn1``,
    ``layer{s}_``). ``dcn``: the ``DeformConv2dPack`` options of the
    ``stage_with_dcn`` stages' 3x3s (``resnet.dcn_spec``)."""

    def __init__(self, arch='regnetx_3.2gf', stem_channels: int = 32,
                 strides: Sequence[int] = (2, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4):
        super().__init__()
        widths, blocks, bot_muls, groups = regnet_layout(arch)
        norm = Norm()
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.conv1 = nn.Conv2d(3, stem_channels, 3, 2, 1, bias=False)
        self.bn1 = norm.make(stem_channels)
        self.num_stages = len(widths)
        inplanes = stem_channels
        for i, (w, n, bm, g) in enumerate(zip(widths, blocks, bot_muls,
                                              groups)):
            bw = int(w * bm)
            layer = []
            for b in range(n):
                layer.append(RegNetBlock(inplanes, w, bw, g,
                                         strides[i] if b == 0 else 1,
                                         downsample=b == 0, norm=norm,
                                         dcn=dcn if stage_with_dcn[i]
                                         else None))
                inplanes = w
            setattr(self, f'layer{i + 1}', nn.Sequential(*layer))

    def frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [
            getattr(self, f'layer{i}') for i in range(1, self.frozen_stages
                                                      + 1)]

    def weight_fault(self, key: str, shape) -> Optional[str]:
        """Why a checkpoint tensor ``key`` (the backbone's own name) of
        ``shape`` is refused, or None: a ``conv2.weight`` grouped as mmdet
        groups it does not fit JAX's group count (3ag)."""
        parts = key.split('.')
        if len(parts) != 4 or parts[2:] != ['conv2', 'weight']:
            return None
        try:
            conv = getattr(self, parts[0])[int(parts[1])].conv2
        except (AttributeError, IndexError, ValueError):
            return None
        if tuple(shape) == tuple(conv.weight.shape):
            return None
        return (f'{key}: the checkpoint\'s {tuple(shape)} does not fit this '
                f'RegNet\'s {tuple(conv.weight.shape)} ({conv.groups} '
                'groups: the JAX package takes the group width as the group '
                f'count, {FAULT}); the weight is not reshaped')

    def forward(self, x: torch.Tensor):
        x = F.relu(self.bn1(self.conv1(x)))
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
