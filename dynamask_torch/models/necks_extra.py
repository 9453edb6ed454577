"""The extra necks (port of ``dynamask_tpu/models/necks_extra.py``):
Libra R-CNN's ``BFP`` with its ``NonLocal2d`` refinement (:77-140), a
list of necks run in turn (``NeckChain``, JAX's ``ChainedNeck``),
``NASFPN`` with its ``SumCell`` and ``GlobalPoolingCell`` (:40-75,
:142-180), and DetectoRS' Recursive Feature Pyramid (``ASPP`` :182-206,
``RFP`` :208-235).

BFP and NAS-FPN resize a map as JAX's ``_resize_to`` (:23-33) does: up by
whole-number repeats of the target's size over the map's, down by a
window minimum over ``k x k`` windows, ``k`` the ratio of the heights
(mmcv takes the maximum). Where that misses the target's size (a ratio
that is not a whole number: ROADMAP.md queue 3, 3bj), JAX's sum of the
two fails with a ``TypeError``; the port raises a ``ValueError`` naming
3bj and both shapes.

``RFP`` is the FPN (mmdet's ``RFP`` subclasses it, so its convs keep the
FPN's names), then ``rfp_steps - 1`` rounds: ASPP-compressed pyramid
levels fed back into a fresh backbone (``rfp_modules.{i}``) over the input
images, the shared FPN over its outputs, fused with the previous round by
a zero-init sigmoid gate (``rfp_weight``) of the new levels. It is called
with the images as well as the first backbone's outputs
(``takes_images``; ``models/detectors.py`` ``extract_feat``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..utils.registry import NECKS
from .fpn import FPN
from .layers import ConvModule


def resize_to(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """NCHW ``x`` at the (h, w) ``hw`` as JAX's ``_resize_to``: nearest by
    whole-number repeats up, the minimum over ``k x k`` windows down (``k``
    the heights' ratio); a ValueError (3bj) where that misses ``hw``."""
    h, w = hw
    xh, xw = x.shape[-2:]
    if (xh, xw) == (h, w):
        return x
    if xh < h:
        out = x.repeat_interleave(h // xh, 2).repeat_interleave(w // xw, 3)
    else:
        k = xh // h
        out = -F.max_pool2d(-x, k, k)
    if tuple(out.shape[-2:]) != (h, w):
        raise ValueError(
            f'{xh}x{xw} resized to {h}x{w} by whole-number ratios gives '
            f'{out.shape[-2]}x{out.shape[-1]} (ROADMAP.md queue 3, 3bj: the '
            'JAX package fails there)')
    return out


def _lecun(conv: ConvModule) -> ConvModule:
    """``conv`` with flax's default init: JAX's BFP and NAS-FPN convs name
    none."""
    conv.conv.init_rule = 'lecun'
    return conv


class NonLocal2d(nn.Module):
    """The embedded-Gaussian non-local block BFP refines with (mmcv's
    ``NonLocal2d`` at reduction 1, no scale): 1x1 ``g``, ``theta`` and
    ``phi``, a softmax over ``theta . phi``, the attended ``g`` through a
    zero-initialised 1x1 ``conv_out``, added to the input."""

    def __init__(self, channels: int):
        super().__init__()
        for name in ('g', 'theta', 'phi', 'conv_out'):
            setattr(self, name, _lecun(ConvModule(channels, channels, 1)))
        self.conv_out.conv.init_rule = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, h, w = x.shape

        def flat(conv):
            return conv(x).reshape(n, c, h * w).transpose(1, 2)

        attn = torch.softmax(flat(self.theta) @ flat(self.phi).transpose(1, 2),
                             -1)
        y = (attn @ flat(self.g)).transpose(1, 2).reshape(n, c, h, w)
        return x + self.conv_out(y.contiguous(
            memory_format=torch.channels_last))


@NECKS.register_module()
class BFP(nn.Module):
    """Libra R-CNN's balanced feature pyramid: the levels resized to level
    ``refine_level``'s size and averaged, refined (a 3x3 conv and a ReLU,
    a ``NonLocal2d``, or nothing), resized back and added to each level."""

    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 2, refine_type: Optional[str] = None):
        super().__init__()
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        if refine_type == 'conv':
            self.refine = _lecun(ConvModule(in_channels, in_channels, 3,
                                            padding=1))
        elif refine_type == 'non_local':
            self.refine = NonLocal2d(in_channels)
        elif refine_type is not None:
            raise NotImplementedError(f'BFP refine_type {refine_type!r}')

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        if len(inputs) != self.num_levels:
            raise ValueError(f'BFP: {len(inputs)} levels, num_levels '
                             f'{self.num_levels}')
        size = tuple(inputs[self.refine_level].shape[-2:])
        feats = [resize_to(f, size) for f in inputs]
        bsf = sum(feats) / len(feats)
        if self.refine_type == 'conv':
            bsf = F.relu(self.refine(bsf))
        elif self.refine_type == 'non_local':
            bsf = self.refine(bsf)
        return tuple(resize_to(bsf, tuple(f.shape[-2:])) + f for f in inputs)


class NeckChain(nn.Sequential):
    """A config's list of necks, each run on the one before's outputs
    (mmdet's ``nn.Sequential``: their keys ``neck.{i}.``)."""


class MergeCell(nn.Module):
    """A NAS-FPN merging cell: both inputs resized to the output size,
    summed (``SumCell``) or the second plus the first gated by the sigmoid
    of the second's global average (``GlobalPoolingCell``, ``gp``); with
    ``with_out_conv`` then a ReLU and a biased 3x3 conv (``out_conv``,
    mmcv's (act, conv, norm) order without a norm)."""

    def __init__(self, channels: int, gp: bool, with_out_conv: bool = True):
        super().__init__()
        self.gp = gp
        if with_out_conv:
            self.out_conv = _lecun(ConvModule(channels, channels, 3,
                                              padding=1))

    def forward(self, x1, x2, out_size):
        x1, x2 = resize_to(x1, out_size), resize_to(x2, out_size)
        if self.gp:
            x = x2 + torch.sigmoid(x2.mean((2, 3), keepdim=True)) * x1
        else:
            x = x1 + x2
        if hasattr(self, 'out_conv'):
            x = self.out_conv(F.relu(x))
        return x


# a NAS-FPN stack's cells in order: (name, global pooling, out conv, first
# input, second input, output) over P3-P7; 'p4_1', 'p4_2', 'p5_tmp' and
# 'p7_tmp' are its intermediates, each at its level's size
NAS_CELLS = (('gp_64_4', True, True, 'p6', 'p4', 'p4_1'),
             ('sum_44_4', False, True, 'p4_1', 'p4', 'p4_2'),
             ('sum_43_3', False, True, 'p4_2', 'p3', 'p3'),
             ('sum_34_4', False, True, 'p3', 'p4_2', 'p4'),
             ('gp_43_5', True, False, 'p4', 'p3', 'p5_tmp'),
             ('sum_55_5', False, True, 'p5', 'p5_tmp', 'p5'),
             ('gp_54_7', True, False, 'p5', 'p4_2', 'p7_tmp'),
             ('sum_77_7', False, True, 'p7', 'p7_tmp', 'p7'),
             ('gp_75_6', True, True, 'p7', 'p5', 'p6'))
LEVELS = ('p3', 'p4', 'p5', 'p6', 'p7')


@NECKS.register_module()
class NASFPN(nn.Module):
    """NAS-FPN for RetinaNet: a biased 1x1 lateral conv on each input from
    ``start_level``, each extra level a 1x1 conv and a 2x2 max pool of
    stride 2 on the level before, then ``stack_times`` stacks of the
    searched merging cells over P3-P7 (``fpn_stages.{t}.{cell}``)."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 stack_times: int = 7, start_level: int = 0):
        super().__init__()
        if num_outs != len(LEVELS):
            raise NotImplementedError(f'NASFPN num_outs {num_outs} (its '
                                      'cells merge P3-P7)')
        self.start_level = start_level
        self.lateral_convs = nn.ModuleList(
            [_lecun(ConvModule(c, out_channels, 1)) for c in in_channels])
        self.extra_downsamples = nn.ModuleList(
            [nn.Sequential(_lecun(ConvModule(out_channels, out_channels, 1)),
                           nn.MaxPool2d(2, 2))
             for _ in range(num_outs - len(in_channels))])
        self.fpn_stages = nn.ModuleList([nn.ModuleDict(
            {name: MergeCell(out_channels, gp, conv)
             for name, gp, conv, *_ in NAS_CELLS})
            for _ in range(stack_times)])

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        ins = list(inputs)[self.start_level:]
        if len(ins) != len(self.lateral_convs):
            raise ValueError(f'NASFPN: {len(ins)} inputs from level '
                             f'{self.start_level}, '
                             f'{len(self.lateral_convs)} laterals')
        feats = [conv(x) for conv, x in zip(self.lateral_convs, ins)]
        for down in self.extra_downsamples:
            feats.append(down(feats[-1]))
        p = dict(zip(LEVELS, feats))
        for stage in self.fpn_stages:
            for name, _, _, a, b, out in NAS_CELLS:
                p[out] = stage[name](p[a], p[b], tuple(p[out[:2]].shape[-2:]))
        return tuple(p[k] for k in LEVELS)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling as DetectoRS' RFP uses it: a 3x3 conv
    at each dilation > 1 (padding the dilation), a 1x1 at dilation 1, the
    last one on the global average broadcast back, each with its bias and
    a ReLU, concatenated (``aspp.{i}``, He over fan-out as in JAX)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilations: Sequence[int] = (1, 3, 6, 1)):
        super().__init__()
        self.aspp = nn.ModuleList()
        for d in dilations:
            k, pad = (3, d) if d > 1 else (1, 0)
            conv = nn.Conv2d(in_channels, out_channels, k, padding=pad,
                             dilation=d)
            conv.init_rule = 'he'
            self.aspp.append(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gap = x.mean((2, 3), keepdim=True)
        last = len(self.aspp) - 1
        outs = [F.relu(conv(gap if i == last else x))
                for i, conv in enumerate(self.aspp)]
        outs[-1] = outs[-1].expand_as(outs[-2])
        return torch.cat(outs, 1)


@NECKS.register_module()
class RFP(FPN):
    takes_images = True

    def __init__(self, rfp_backbones: Sequence[nn.Module],
                 aspp_out_channels: int = 64,
                 aspp_dilations: Sequence[int] = (1, 3, 6, 1), **fpn):
        super().__init__(**fpn)
        out = self.fpn_convs[0].conv.out_channels
        self.rfp_modules = nn.ModuleList(rfp_backbones)
        # the fresh backbones sit under ``neck.``, whose default init is the
        # FPN's: their plain convs take a backbone's He init
        for m in self.rfp_modules.modules():
            if isinstance(m, nn.Conv2d) and not hasattr(m, 'init_rule'):
                m.init_rule = 'he'
        self.rfp_aspp = ASPP(out, aspp_out_channels, aspp_dilations)
        self.rfp_weight = nn.Conv2d(out, 1, 1)
        self.rfp_weight.init_rule = 0.0

    def forward(self, images: torch.Tensor,
                inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        """The first pyramid under the ``fpn`` range; each round's ASPP and
        backbone pass under ``rfp_backbone``, its pyramid and gate under
        ``rfp_neck``."""
        with record_function('fpn'):
            x = super().forward(inputs)
        for backbone in self.rfp_modules:
            with record_function('rfp_backbone'):
                rfp_feats = [self.rfp_aspp(x[i + 1])
                             for i in range(len(backbone.out_indices) - 1)]
                c = backbone(images, rfp_feats)
            with record_function('rfp_neck'):
                x_new = super().forward(c)
                gates = [torch.sigmoid(self.rfp_weight(xi)) for xi in x_new]
                x = tuple(g * xi + (1 - g) * xo
                          for g, xi, xo in zip(gates, x_new, x))
        return x
