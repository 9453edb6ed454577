"""NAS-FCOS (port of ``dynamask_tpu/models/nasfcos.py``): FCOS on the
searched pyramid ``NASFCOS_FPN`` (a fixed DAG of ``ConcatCell`` s over
c3-c5, two strided extra levels) and, in the nashead config, the searched
head ``NASFCOSHead`` (each tower "DCNv2 3x3, conv 3x3, DCNv2 3x3, conv
1x1", GN and ReLU after each; centerness on the cls tower; distances
``exp(scale * reg)``, in pixels, without the stride).

The head's DCNv2 is JAX's windowed ``modulated_deform_conv2d``
(displacements clipped to +-3; mmcv's is unbounded: ROADMAP.md queue 3,
3bf). JAX's neck drops the config's ``conv_cfg=DCNv2`` and
``norm_cfg=BN`` for the cells' input convs, which are plain bias-free 3x3
convs there (mmcv builds them as biased DCNv2s under BN): the port computes
JAX's neck and refuses, by name on load, any tensor JAX's neck lacks
(3bg). The extra levels are JAX's: a bias-free 3x3 stride-2 conv and a
BatchNorm, ReLU before all but the first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.fp16 import at_least_f32
from ..ops import deform_conv as dcn_ops
from ..utils.registry import DETECTORS, HEADS, NECKS
from .atss import Scale
from .fcos import FCOS
from .layers import (BatchNorm2dBiasedVar, ConvModule, GroupNorm,
                     WeightFaults, to_nchw, to_nhwc)
from .single_stage import PRIOR_BIAS, head_conv

# the searched wiring (JAX ``nasfcos.py:104-112``): (cell, input 1, input 2,
# input 1 conv, input 2 conv) over the adapted c3 (0), c4 (1), c5 (2)
WIRING = (('c22_1', 2, 2, True, True), ('c22_2', 2, 2, True, True),
          ('c32', 3, 2, True, False), ('c02', 0, 2, True, False),
          ('c42', 4, 2, True, True), ('c36', 3, 6, True, True),
          ('c61', 6, 1, True, True))


def _he(conv: nn.Module) -> nn.Module:
    """He-normal over fan-out, JAX's ``kaiming_normal_fan_out`` (the
    neck's default rule is Xavier)."""
    conv.init_rule = 'he'
    return conv


def resize_to(x: torch.Tensor, hw) -> torch.Tensor:
    """A cell's resize (JAX ``_resize_to``): nearest repeat up by integer
    factors, max pool down."""
    h, w = hw
    if tuple(x.shape[-2:]) == (h, w):
        return x
    if x.shape[-2] < h:
        return x.repeat_interleave(h // x.shape[-2], -2).repeat_interleave(
            w // x.shape[-1], -1)
    r = x.shape[-2] // h
    return F.max_pool2d(x, r, r)


def bilinear_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(method='bilinear')``: half-pixel centres, and
    antialiased (a triangle filter widened by the factor) going down."""
    if tuple(x.shape[-2:]) == tuple(hw):
        return x
    return F.interpolate(x, size=tuple(hw), mode='bilinear',
                         align_corners=False, antialias=True)


class NormActConv(nn.Module):
    """A cell's out conv in (norm, act, conv) order: BatchNorm over the
    concatenation, ReLU, a bias-free 1x1 conv in ``channels`` groups
    (mmcv's ``out_conv.bn`` / ``out_conv.conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm2dBiasedVar(2 * channels, eps=1e-5)
        self.conv = _he(nn.Conv2d(2 * channels, channels, 1, groups=channels,
                                  bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.relu(self.bn(x)))


class ConcatCell(nn.Module):
    """mmcv's ``ConcatCell`` as JAX computes it: each input through its
    bias-free 3x3 ``input{1,2}_conv`` (where present), resized to the
    larger of the two, concatenated, then ``out_conv``."""

    def __init__(self, channels: int, with_input1_conv: bool = True,
                 with_input2_conv: bool = True):
        super().__init__()
        for i, on in ((1, with_input1_conv), (2, with_input2_conv)):
            if on:
                conv = ConvModule(channels, channels, 3, padding=1,
                                  bias=False)
                _he(conv.conv)
                setattr(self, f'input{i}_conv', conv)
        self.out_conv = NormActConv(channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if hasattr(self, 'input1_conv'):
            x1 = self.input1_conv(x1)
        if hasattr(self, 'input2_conv'):
            x2 = self.input2_conv(x2)
        hw = (max(x1.shape[-2], x2.shape[-2]), max(x1.shape[-1], x2.shape[-1]))
        return self.out_conv(torch.cat([resize_to(x1, hw), resize_to(x2, hw)],
                                       1))


@NECKS.register_module()
class NASFCOS_FPN(WeightFaults, nn.Module):
    """The searched pyramid (JAX ``NASFCOS_FPN``): ``adapt_convs`` (1x1,
    BN, ReLU) of c3-c5, the cells ``fpn.<name>``, P3-P5 as bilinear
    resizes of (cell + the resized ``c32``) to the backbone's c3-c5, then
    ``extra_downsamples``."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 1):
        super().__init__()
        self.start_level = start_level
        self.adapt_convs = nn.ModuleList()
        for c in in_channels[start_level:]:
            conv = ConvModule(c, out_channels, 1, bias=False, bn=True)
            _he(conv.conv)
            self.adapt_convs.append(conv)
        self.fpn = nn.ModuleDict({name: ConcatCell(out_channels, w1, w2)
                                  for name, _, _, w1, w2 in WIRING})
        self.extra_downsamples = nn.ModuleList()
        for _ in range(num_outs - 3):
            conv = ConvModule(out_channels, out_channels, 3, padding=1,
                              stride=2, bias=False, bn=True)
            _he(conv.conv)
            self.extra_downsamples.append(conv)

    def weight_fault(self, key: str, shape) -> Optional[str]:
        """A checkpoint tensor the JAX package's neck has no place for
        (mmcv's DCNv2 offsets, biases and BatchNorms of the cells' input
        convs, the extra convs' biases) is refused by name."""
        if key in self.state_dict():
            return None
        return (f'neck.{key}: the JAX package\'s NAS-FCOS neck has no such '
                'tensor: it drops the config\'s conv_cfg=DCNv2 and '
                'norm_cfg=BN for the cells\' input convs (ROADMAP.md '
                'queue 3, 3bg)')

    def forward(self, inputs: Sequence[torch.Tensor]):
        feats = [F.relu(conv(x)) for conv, x in
                 zip(self.adapt_convs, inputs[self.start_level:])]
        for name, i1, i2, _, _ in WIRING:
            feats.append(self.fpn[name](feats[i1], feats[i2]))
        ret = []
        for idx, level in zip((9, 8, 7), (1, 2, 3)):
            f1 = feats[idx]
            f2 = bilinear_resize(feats[5], f1.shape[-2:])
            ret.append(bilinear_resize(f1 + f2, inputs[level].shape[-2:]))
        for i, conv in enumerate(self.extra_downsamples):
            ret.append(conv(F.relu(ret[-1]) if i else ret[-1]))
        return ret


class ModulatedDeformConv2dPack(nn.Module):
    """mmcv's ``ModulatedDeformConv2dPack`` as JAX's ``MDCNBlock``: a 3x3
    DCNv2 in ``deform_groups`` groups whose offsets and mask logits come
    from its own ``conv_offset`` (zero at init), with a ``bias``; the
    windowed form (``ops.modulated_deform_conv2d``, +-3)."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 2):
        super().__init__()
        self.deform_groups = deform_groups
        self.conv_offset = nn.Conv2d(in_channels, 27 * deform_groups, 3,
                                     padding=1)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        om = to_nhwc(self.conv_offset(x))
        n = 18 * self.deform_groups
        out = dcn_ops.modulated_deform_conv2d(
            to_nhwc(x), om[..., :n], torch.sigmoid(om[..., n:]),
            self.weight.permute(2, 3, 1, 0), 3, 1, 1, self.deform_groups)
        return to_nchw(out + self.bias)


class NASOp(nn.Module):
    """One op of the searched tower and its GN and ReLU (mmcv's
    ``ConvModule`` names ``.conv``, ``.gn``); JAX's convs keep their
    bias."""

    def __init__(self, conv: nn.Module, channels: int, gn_groups: int):
        super().__init__()
        self.conv = conv
        self.gn = GroupNorm(gn_groups, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


@HEADS.register_module()
class NASFCOSHead(nn.Module):
    """The searched towers, ``conv_cls`` (the prior bias), ``conv_reg``
    and ``conv_centerness`` (on the cls tower), a ``Scale`` a level; ->
    per level scores, fp32 distances ``exp(scale * reg)``, centerness
    logits."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gn_groups: int = 32):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        for tower in ('cls_convs', 'reg_convs'):
            ops = []
            for i, k in enumerate((0, 3, 0, 1)):
                cin = in_channels if i == 0 else feat_channels
                conv = (ModulatedDeformConv2dPack(cin, feat_channels) if k == 0
                        else nn.Conv2d(cin, feat_channels, k, padding=k // 2))
                ops.append(NASOp(conv, feat_channels, gn_groups))
            setattr(self, tower, nn.ModuleList(ops))
        self.conv_cls = head_conv(feat_channels, num_classes,
                                  bias_init=PRIOR_BIAS)
        self.conv_reg = head_conv(feat_channels, 4)
        self.conv_centerness = head_conv(feat_channels, 1)
        self.scales = nn.ModuleList([Scale() for _ in self.strides])

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, cent_out = [], [], []
        for x, scale in zip(feats, self.scales):
            c, r = x, x
            for op in self.cls_convs:
                c = op(c)
            for op in self.reg_convs:
                r = op(r)
            cls_out.append(self.conv_cls(c))
            cent_out.append(self.conv_centerness(c))
            reg_out.append(torch.exp(scale(at_least_f32(self.conv_reg(r)))))
        return cls_out, reg_out, cent_out


@DETECTORS.register_module()
class NASFCOS(FCOS):
    """mmdet's ``NASFCOS``: FCOS on the searched neck (and head)."""
