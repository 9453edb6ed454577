"""DetectoRS' ResNet: Switchable Atrous Convolution and the Recursive
Feature Pyramid's feedback (port of ``dynamask_tpu/models/
detectors_resnet.py``: ``SAConv`` :30-101, ``SACBottleneck`` :104-170,
``DetectoRSResNet`` and ``DetectoRS_ResNeXt`` :173-237).

A SAC stage's 3x3 (mmcv's ``SAConv2d``, under the block's ``conv2``
name) is one weight-standardised kernel evaluated at two atrous rates, d
and 3d, blended per pixel by a switch that a 1x1 conv predicts from the
5x5 reflect-padded average of its input, between two zero-init global
context 1x1 convs. ``sac.use_deform`` puts each branch through a
deformable conv with its own zero-init 3x3 offset conv: at stride 1 the
windowed form (``window=3``) through K1 / K3 at dilation d and 3d, at
stride 2 the exact gather (plain PyTorch, as XLA computes it in JAX). The
first block of every stage past the first adds a zero-init 1x1
``rfp_conv`` of the RFP's feedback (``rfp_inplanes`` set).

As in JAX (ROADMAP.md queue 3): the standardisation is ``(w - mean) /
(std + 1e-5)`` with the biased deviation and no ``weight_gamma`` /
``weight_beta``, and the block's other convs are plain whatever
``conv_cfg`` says (3at); at stride 1 the offsets start at exactly zero,
where the windowed form's offset gradient is zero, so they never train
(3f), while the strided ones move (3ak); the windowed branches clip their
displacements to ±3 where mmcv's DCN is unbounded (3au). Every stage's
block is a Bottleneck (expansion 4), whatever the depth's table says.
The stem and the first ``frozen_stages`` stages are frozen as the other
backbones' are, where JAX's trainer cannot build a DetectoRS optimizer
(3av).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import deform_conv as dcn_ops
from ..utils.registry import BACKBONES
from .layers import to_nchw, to_nhwc
from .resnet import ARCH_SETTINGS, Backbone, Norm


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``x`` reflect-padded by ``p`` on H and W as ``jnp.pad(mode=
    'reflect')`` pads it: ``F.pad`` where each side is longer than ``p``,
    numpy's repeated reflection on a shorter one (a toy's 2x2 map)."""
    if min(x.shape[-2:]) > p:
        return F.pad(x, (p, p, p, p), mode='reflect')
    for dim in (2, 3):
        idx = np.pad(np.arange(x.shape[dim]), p, mode='reflect')
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def _zero_conv(cin: int, cout: int, kernel: int = 1, stride: int = 1,
               padding: int = 0) -> nn.Conv2d:
    conv = nn.Conv2d(cin, cout, kernel, stride, padding)
    conv.init_rule = 0.0
    return conv


class SAConv(nn.Module):
    """mmcv's ``SAConv2d`` as the JAX package computes it: ``weight`` (He
    over fan-out) and the zero-init ``weight_diff`` of the large branch,
    ``pre_context`` / ``post_context``, ``switch`` (weight 0, bias 1) and,
    with ``use_deform``, ``offset_s`` / ``offset_l``."""

    init_rule = 'he'
    init_fill = {'weight_diff': 0.0}

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, use_deform: bool = False,
                 groups: int = 1):
        super().__init__()
        if use_deform and groups > 1:
            raise NotImplementedError(
                'SAC deform path does not support grouped conv')
        self.stride, self.dilation = stride, dilation
        self.use_deform, self.groups = use_deform, groups
        shape = (out_channels, in_channels // groups, 3, 3)
        self.weight = nn.Parameter(torch.empty(shape))
        self.weight_diff = nn.Parameter(torch.empty(shape))
        self.pre_context = _zero_conv(in_channels, in_channels)
        self.post_context = _zero_conv(out_channels, out_channels)
        self.switch = _zero_conv(in_channels, 1, stride=stride)
        self.switch.init_fill = {'bias': 1.0}
        if use_deform:
            self.offset_s = _zero_conv(in_channels, 18, 3, stride, 1)
            self.offset_l = _zero_conv(in_channels, 18, 3, stride, 1)

    def standardised(self) -> torch.Tensor:
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(1).reshape(-1, 1, 1, 1)
        std = flat.std(1, unbiased=False).reshape(-1, 1, 1, 1)
        return (w - mean) / (std + 1e-5)

    def branch(self, x: torch.Tensor, weight: torch.Tensor, dil: int,
               offset: Optional[nn.Module]) -> torch.Tensor:
        if offset is None:
            return F.conv2d(x, weight, None, self.stride, dil, dil,
                            self.groups)
        off = to_nhwc(offset(x))
        if self.stride == 1:
            return to_nchw(dcn_ops.deform_conv2d_nhwc(
                to_nhwc(x), off, weight, 3, dil, dil, 1, 3))
        return to_nchw(dcn_ops.deform_conv2d_exact(
            to_nhwc(x), off, weight.permute(2, 3, 1, 0), None, 3,
            self.stride, dil, dil, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ws = self.standardised()
        x = x + self.pre_context(x.mean((2, 3), keepdim=True))
        avg = F.avg_pool2d(reflect_pad(x, 2), 5, 1)
        switch = torch.sigmoid(self.switch(avg))
        d = self.dilation
        out_s = self.branch(x, ws, d, getattr(self, 'offset_s', None))
        out_l = self.branch(x, ws + self.weight_diff, 3 * d,
                            getattr(self, 'offset_l', None))
        out = switch * out_s + (1 - switch) * out_l
        return out + self.post_context(out.mean((2, 3), keepdim=True))


class SACBottleneck(nn.Module):
    """A Bottleneck (the stride on the 3x3) whose ``conv2`` is a
    :class:`SAConv` in a SAC stage, with the zero-init ``rfp_conv``
    (biased, ``rfp_inplanes`` -> ``planes * 4``) of the RFP's feedback
    when ``rfp_inplanes`` is set. A ResNeXt block is ``groups`` wide
    groups of ``planes * base_width // 64``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_sac: bool = False,
                 use_deform: bool = False,
                 rfp_inplanes: Optional[int] = None, groups: int = 1,
                 base_width: int = 4, norm: Optional[Norm] = None):
        super().__init__()
        norm = norm or Norm()
        width = planes if groups == 1 else (
            planes * base_width // 64) * groups
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = norm.make(width)
        self.conv2 = (SAConv(width, width, stride, 1, use_deform, groups)
                      if with_sac else
                      nn.Conv2d(width, width, 3, stride, 1, groups=groups,
                                bias=False))
        self.bn2 = norm.make(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = norm.make(out, zero_init=True)
        self.downsample = (nn.Sequential(
            nn.Conv2d(inplanes, out, 1, stride, bias=False), norm.make(out))
            if downsample else None)
        self.rfp_conv = (None if rfp_inplanes is None else
                         _zero_conv(rfp_inplanes, out))

    def forward(self, x: torch.Tensor,
                rfp_feat: Optional[torch.Tensor] = None) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out)) + identity
        if self.rfp_conv is not None and rfp_feat is not None:
            out = out + self.rfp_conv(rfp_feat)
        return F.relu(out)


@BACKBONES.register_module(name='DetectoRS_ResNet')
class DetectoRSResNet(Backbone):
    """The 7x7 stem, then ``num_stages`` stages of ``SACBottleneck`` (SAC in
    the stages of ``stage_with_sac``); ``forward(x, rfp_feats)`` adds
    ``rfp_feats[i - 1]`` into stage i's first block (an RFP step), or
    nothing (``rfp_feats`` None: a plain forward). The stem and the first
    ``frozen_stages`` stages are frozen."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3),
                 frozen_stages: int = 1, norm_eval: bool = True,
                 stage_with_sac: Tuple[bool, ...] = (False, True, True, True),
                 sac_use_deform: bool = False,
                 rfp_inplanes: Optional[int] = None, groups: int = 1,
                 base_width: int = 4):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'DetectoRS ResNet depth {depth} is not ported')
        stage_blocks = ARCH_SETTINGS[depth][1]
        norm = Norm()
        self.out_indices = tuple(out_indices)
        self.frozen_stages, self.norm_eval = frozen_stages, norm_eval
        self.num_stages = num_stages
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = norm.make(64)
        inplanes, planes = 64, 64
        for i in range(num_stages):
            blocks = []
            for b in range(stage_blocks[i]):
                blocks.append(SACBottleneck(
                    inplanes, planes, (1 if i == 0 else 2) if b == 0 else 1,
                    downsample=b == 0, with_sac=stage_with_sac[i],
                    use_deform=sac_use_deform,
                    rfp_inplanes=(rfp_inplanes if i > 0 and b == 0
                                  else None),
                    groups=groups, base_width=base_width, norm=norm))
                inplanes = planes * SACBottleneck.expansion
            setattr(self, f'layer{i + 1}', nn.Sequential(*blocks))
            planes *= 2

    refuses_missing_keys = True     # weight_gamma / weight_beta (3at)

    def weight_fault(self, key: str, shape) -> Optional[str]:
        """mmcv ``ConvAWS2d``'s ``weight_gamma`` / ``weight_beta`` (an mmdet
        DetectoRS checkpoint's) are refused on load: the JAX package builds
        these convs plain and SAC without them (3at)."""
        if key.rpartition('.')[2] not in ('weight_gamma', 'weight_beta'):
            return None
        return (f'{key}: ConvAWS\'s affine has no place in this backbone (the '
                'JAX package drops conv_cfg=ConvAWS and standardises SAC '
                'without it, ROADMAP.md queue 3, 3at)')

    def frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [
            getattr(self, f'layer{i}')
            for i in range(1, self.frozen_stages + 1)]

    def forward(self, x: torch.Tensor,
                rfp_feats: Optional[Sequence[torch.Tensor]] = None):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            for b, block in enumerate(getattr(self, f'layer{i + 1}')):
                x = block(x, rfp_feats[i - 1] if rfp_feats is not None and
                          i > 0 and b == 0 else None)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module(name='DetectoRS_ResNeXt')
class DetectoRS_ResNeXt(DetectoRSResNet):
    """DetectoRS on a ResNeXt trunk: grouped 3x3s (or SAC convs) of
    ``groups`` groups of ``planes * base_width // 64``."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)
