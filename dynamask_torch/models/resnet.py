"""ResNet backbone family (port of ``dynamask_tpu/models/resnet.py``):
depths 18 and 34 (BasicBlock), 50, 101 and 152 (Bottleneck), with the
variants the JAX ``ResNet`` takes (``:286-405``) and its builder registers
(``dynamask_tpu/models/builder.py:28-86``):

* ``style``: 'pytorch' puts a Bottleneck's stride on the 3×3, 'caffe' on
  the first 1×1 (JAX ``:244-246``);
* ``groups`` / ``base_width``: ResNeXt, the Bottleneck width
  ``int(planes * base_width / 64) * groups`` with a grouped 3×3 (JAX
  ``:247``), registered as ``ResNeXt``;
* ``deep_stem``: ResNetV1d's stem of three 3×3 convs (JAX ``:330-339``),
  registered as ``ResNetV1d``; ``avg_down`` is accepted and unused, as in
  JAX (``:306``; ROADMAP.md queue 3);
* ``norm_cfg``: ``BN`` and ``SyncBN`` (BatchNorm on one device), or ``GN``
  with ``num_groups`` (flax's GroupNorm, eps 1e-6); ``requires_grad`` is
  read as JAX reads it, not at all: the affine of a stage past
  ``frozen_stages`` trains (ROADMAP.md queue 3);
* ``conv_cfg=ConvWS``: the blocks' convs weight-standardised (the stem's
  and the projections' stay plain, as in JAX; ROADMAP.md queue 3).

Module names follow mmdet, so the state dict reads
``backbone.layer1.0.conv1.weight``, ``...bn1`` (``gn1`` under GN), and
``backbone.stem.{0,1,3,4,6,7}`` for the deep stem. The JAX stem is
``S2DStemConv`` (``resnet.py:45``), an exact TPU layout rewrite of the
7×7 stride-2 conv; the port runs the plain conv. In training
(``resnet.py:197,243,321,347-388``): ``frozen_stages = n`` freezes the
stem and the first n stages (no gradient, no update, no weight decay: their
parameters stop requiring a gradient), and ``norm_eval`` keeps every
BatchNorm on its running statistics when the model is put in training
mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import BACKBONES
from .layers import BatchNorm2d, ConvWS2d, GroupNorm

# where the ResNet options the port lacks are queued (ROADMAP.md §1)
NOT_PORTED = {'dcn': 7, 'stage_with_dcn': 7, 'plugins': 7, 'strides': 9,
              'dilations': 9}


class Norm:
    """The norm layer of a ``norm_cfg``: ``make(c, zero_init)`` builds one
    (``zero_init``: the block's last, whose scale starts at 0,
    ``zero_init_residual``), ``abbr`` is mmdet's name for it ('bn', 'gn')."""

    def __init__(self, norm_cfg: Optional[dict] = None):
        cfg = dict(norm_cfg or {})
        kind = cfg.pop('type', 'BN')
        cfg.pop('requires_grad', None)   # not read: JAX trains the affine
        self.groups = cfg.pop('num_groups', 32) if kind == 'GN' else None
        if kind not in ('BN', 'SyncBN', 'GN') or cfg:
            raise NotImplementedError(
                f'ResNet norm_cfg {norm_cfg}: the port has BN, SyncBN (as '
                'BN on one device) and GN(num_groups)')
        self.abbr = 'gn' if kind == 'GN' else 'bn'

    def make(self, c: int, zero_init: bool = False) -> nn.Module:
        # a layers.BatchNorm2d takes fp32 statistics under a bf16 scale
        norm = (GroupNorm(self.groups, c) if self.groups
                else BatchNorm2d(c, eps=1e-5))
        norm.zero_init = zero_init
        return norm


def _conv_type(conv_cfg: Optional[dict]):
    kind = (conv_cfg or {}).get('type', 'Conv')
    if kind not in ('Conv', 'ConvWS') or len(conv_cfg or {}) > 1:
        raise NotImplementedError(f'ResNet conv_cfg {conv_cfg}: the port '
                                  'has Conv and ConvWS')
    return ConvWS2d if kind == 'ConvWS' else nn.Conv2d


class _Block(nn.Module):
    def _add_norm(self, i: int, norm: Norm, c: int, zero_init=False):
        name = f'{norm.abbr}{i}'
        self.add_module(name, norm.make(c, zero_init))
        return name

    def _projection(self, inplanes, out, stride, norm: Norm):
        return nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                             norm.make(out))


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm: Norm = None, conv=nn.Conv2d,
                 zero_init_residual: bool = True, **_):
        super().__init__()
        norm = norm or Norm()
        self.conv1 = conv(inplanes, planes, 3, stride, 1, bias=False)
        self.n1 = self._add_norm(1, norm, planes)
        self.conv2 = conv(planes, planes, 3, 1, 1, bias=False)
        self.n2 = self._add_norm(2, norm, planes, zero_init_residual)
        self.downsample = (self._projection(inplanes, planes, stride, norm)
                           if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(getattr(self, self.n1)(self.conv1(x)))
        out = getattr(self, self.n2)(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, norm: Norm = None, conv=nn.Conv2d,
                 zero_init_residual: bool = True, style: str = 'pytorch',
                 groups: int = 1, base_width: int = 64):
        super().__init__()
        norm = norm or Norm()
        s1, s2 = (1, stride) if style == 'pytorch' else (stride, 1)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1, s1, bias=False)
        self.n1 = self._add_norm(1, norm, width)
        self.conv2 = conv(width, width, 3, s2, 1, groups=groups, bias=False)
        self.n2 = self._add_norm(2, norm, width)
        self.conv3 = conv(width, planes * 4, 1, bias=False)
        self.n3 = self._add_norm(3, norm, planes * 4, zero_init_residual)
        self.downsample = (self._projection(inplanes, planes * 4, stride,
                                            norm) if downsample else None)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(getattr(self, self.n1)(self.conv1(x)))
        out = F.relu(getattr(self, self.n2)(self.conv2(out)))
        out = getattr(self, self.n3)(self.conv3(out))
        return F.relu(out + identity)


def deep_stem_layers(norm: Norm, channels: int) -> nn.Sequential:
    """ResNetV1d's and Res2Net's stem of three 3x3 convs (the first at
    stride 2), mmdet's ``stem.{0,1,3,4,6,7}``."""
    half = channels // 2
    return nn.Sequential(
        nn.Conv2d(3, half, 3, 2, 1, bias=False), norm.make(half), nn.ReLU(),
        nn.Conv2d(half, half, 3, 1, 1, bias=False), norm.make(half),
        nn.ReLU(),
        nn.Conv2d(half, channels, 3, 1, 1, bias=False), norm.make(channels),
        nn.ReLU())


# the JAX package's table (``dynamask_tpu/models/resnet.py:276-282``)
ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


class Backbone(nn.Module):
    """What the port's backbones share in training: ``frozen_modules()``
    (the stem and the frozen stages, each backbone its own) stop requiring
    a gradient in ``freeze_stages()``, and ``norm_eval`` keeps every
    BatchNorm on its running statistics in training mode."""

    frozen_stages = -1
    norm_eval = True

    def frozen_modules(self):
        return []

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


@BACKBONES.register_module()
class ResNet(Backbone):
    """Returns the stage outputs of ``out_indices`` (strides 4/8/16/32)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = True,
                 style: str = 'pytorch', groups: int = 1,
                 base_width: int = 64, deep_stem: bool = False,
                 avg_down: bool = False, stem_channels: int = 64,
                 norm_cfg: Optional[dict] = None,
                 conv_cfg: Optional[dict] = None,
                 zero_init_residual: bool = True, **unported):
        super().__init__()
        if unported:
            raise NotImplementedError('ResNet keys not ported: ' + ', '.join(
                k + (f' (ROADMAP.md §1, item {NOT_PORTED[k]})'
                     if k in NOT_PORTED else '') for k in sorted(unported)))
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'ResNet depth {depth} is not ported')
        if style not in ('pytorch', 'caffe'):
            raise NotImplementedError(f'ResNet style {style!r}')
        block, stage_blocks = ARCH_SETTINGS[depth]
        norm, conv = Norm(norm_cfg), _conv_type(conv_cfg)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.deep_stem = deep_stem
        if deep_stem:
            self.stem = deep_stem_layers(norm, stem_channels)
        else:
            self.conv1 = nn.Conv2d(3, stem_channels, 7, 2, 3, bias=False)
            self.stem_norm = f'{norm.abbr}1'
            self.add_module(self.stem_norm, norm.make(stem_channels))
        inplanes, planes = stem_channels, 64
        self.num_stages = num_stages
        for i, n in enumerate(stage_blocks[:num_stages]):
            stride = 1 if i == 0 else 2
            blocks = []
            for b in range(n):
                first = b == 0
                # Bottleneck stages always project in their first block;
                # BasicBlock stages only where the shape changes
                proj = first and (block is Bottleneck or i > 0)
                blocks.append(block(
                    inplanes, planes, stride if first else 1, downsample=proj,
                    norm=norm, conv=conv,
                    zero_init_residual=zero_init_residual, style=style,
                    groups=groups, base_width=base_width))
                inplanes = planes * block.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            planes *= 2

    def frozen_modules(self):
        """The stem and the first ``frozen_stages`` stages."""
        if self.frozen_stages < 0:
            return []
        stem = ([self.stem] if self.deep_stem else
                [self.conv1, getattr(self, self.stem_norm)])
        return stem + [getattr(self, f'layer{i}')
                       for i in range(1, self.frozen_stages + 1)]

    def forward(self, x: torch.Tensor):
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(getattr(self, self.stem_norm)(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


# ResNeXt is the ResNet of the config's groups and base_width, as the JAX
# builder builds it (builder.py:82-85)
BACKBONES.register_module(name='ResNeXt', module=ResNet)


@BACKBONES.register_module()
class ResNetV1d(ResNet):
    """ResNet with the deep stem; ``avg_down`` is accepted and unused, as
    in JAX."""

    def __init__(self, **kwargs):
        super().__init__(**dict(kwargs, deep_stem=True, avg_down=True))
