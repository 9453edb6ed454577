"""The C4 detectors' shared head (port of
``dynamask_tpu/models/shared_head.py:20-42``, ``ResLayerSharedHead``):
ResNet stage ``stage`` (res5 in the C4 configs), left out of the
backbone (``num_stages=3``), run on every RoI's crop. In the C4 configs a
14x14 crop at 1024 channels leaves it at 7x7 and 2048 channels, which the
plain ``BBoxHead`` average-pools and the mask head upsamples.

Its blocks are Bottlenecks whatever the depth, as JAX builds them (mmdet
would take a ResNet-18's BasicBlocks), the first projecting at
``stride``, every 3x3 at ``dilation``; ``planes = 64 * 2 ** stage``. The
module keeps mmdet's name, ``layer{stage + 1}``, so the state-dict keys
read ``roi_head.shared_head.layer4.{i}.conv1.weight`` as mmdet's do.
``norm_cfg`` is not read (JAX pops it): its ``requires_grad=False``
leaves the BatchNorms' affine trainable, as in the backbone (ROADMAP.md
queue 3, 3j). With ``norm_eval`` the BatchNorms stay on their running
statistics in training mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .resnet import ARCH_SETTINGS, Bottleneck, Norm


class ResLayerSharedHead(nn.Module):
    def __init__(self, in_channels: int, depth: int = 50, stage: int = 3,
                 stride: int = 2, dilation: int = 1, style: str = 'caffe',
                 norm_eval: bool = True):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'ResLayer depth {depth} is not ported')
        if style not in ('pytorch', 'caffe'):
            raise NotImplementedError(f'ResLayer style {style!r}')
        planes = 64 * 2 ** stage
        blocks, inplanes = [], in_channels
        for i in range(ARCH_SETTINGS[depth][1][stage]):
            blocks.append(Bottleneck(inplanes, planes, stride if i == 0 else 1,
                                     downsample=i == 0, norm=Norm(),
                                     style=style, dilation=dilation))
            inplanes = planes * Bottleneck.expansion
        self.layer_name = f'layer{stage + 1}'
        self.add_module(self.layer_name, nn.Sequential(*blocks))
        self.out_channels = inplanes
        self.stride = stride
        self.norm_eval = norm_eval

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, P, P) RoI crops -> (N, 4 * planes, P / stride, ...)."""
        return getattr(self, self.layer_name)(x)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        return self
