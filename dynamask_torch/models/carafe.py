"""CARAFE upsampling: ``CARAFEPack`` and the ``FPN_CARAFE`` neck (port of
``dynamask_tpu/models/carafe.py:23-98``, the JAX form of mmcv's
``CARAFEPack`` and mmdet's ``necks/fpn_carafe.py``).

``CARAFEPack`` compresses the channels (1×1), encodes ``up_kernel``² ×
``scale``² kernel channels (``encoder_kernel`` conv), pixel-shuffles them
onto the upsampled grid, softmaxes each pixel's kernel in fp32 and
reassembles (:func:`dynamask_torch.ops.carafe.carafe`). The FCN mask head's
``upsample_type='carafe'`` is one at 2× with JAX's defaults.

``FPN_CARAFE`` as JAX builds it: a 1×1 lateral of each backbone level and
a 3×3 stride-2 lateral of the previous lateral for each extra level, the
top-down adds through a ``CARAFEPack`` each, and a 3×3 output conv on every
level; no norm, no activation. mmdet's extra lateral reads the last
backbone level (C5, 2048 channels) where JAX's reads the P5 lateral (256),
so an mmdet checkpoint's ``lateral_convs.4`` does not fit (ROADMAP.md queue
3, 3y). The initialisers are JAX's: He-normal over fan-out on every conv,
N(0, 0.001) on the content encoder. mmdet's names:
``lateral_convs.{i}.conv``, ``upsample_modules.{i}.channel_compressor`` /
``.content_encoder``, ``fpn_convs.{i}.conv``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.carafe import carafe
from ..utils.registry import NECKS
from .layers import ConvModule


class CARAFEPack(nn.Module):
    def __init__(self, channels: int, scale: int = 2, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64):
        super().__init__()
        self.scale, self.up_kernel = scale, up_kernel
        self.channel_compressor = nn.Conv2d(channels, compressed_channels, 1)
        self.channel_compressor.init_rule = 'he'
        self.content_encoder = nn.Conv2d(
            compressed_channels, up_kernel ** 2 * scale ** 2, encoder_kernel,
            padding=encoder_kernel // 2)
        self.content_encoder.init_rule = 0.001

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.content_encoder(self.channel_compressor(x))
        masks = F.softmax(F.pixel_shuffle(enc, self.scale).float(), dim=1)
        return carafe(x, masks, self.scale, self.up_kernel)


@NECKS.register_module()
class FPN_CARAFE(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 start_level: int = 0, up_kernel: int = 5,
                 encoder_kernel: int = 3, compressed_channels: int = 64):
        super().__init__()
        self.start_level = start_level
        n_backbone = len(in_channels) - start_level
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels[i + start_level], out_channels, 1)
            if i < n_backbone else
            ConvModule(out_channels, out_channels, 3, padding=1, stride=2)
            for i in range(num_outs))
        self.upsample_modules = nn.ModuleList(
            CARAFEPack(out_channels, 2, up_kernel, encoder_kernel,
                       compressed_channels) for _ in range(num_outs - 1))
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, padding=1)
            for _ in range(num_outs))
        for m in (*self.lateral_convs, *self.fpn_convs):
            m.conv.init_rule = 'he'

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        n_backbone = len(inputs) - self.start_level
        laterals = []
        for i, conv in enumerate(self.lateral_convs):
            laterals.append(conv(inputs[i + self.start_level]
                                 if i < n_backbone else laterals[-1]))
        for i in range(len(laterals) - 1, 0, -1):
            up = self.upsample_modules[i - 1](laterals[i])
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        return tuple(conv(x) for conv, x in zip(self.fpn_convs, laterals))
