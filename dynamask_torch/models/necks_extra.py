"""DetectoRS' Recursive Feature Pyramid (port of the parts of
``dynamask_tpu/models/necks_extra.py`` that DetectoRS runs: ``ASPP``
:182-206 and ``RFP`` :208-235). Libra's BFP and NAS-FPN, the file's other
necks, are not ported (ROADMAP.md §1, item 8).

``RFP`` is the FPN (mmdet's ``RFP`` subclasses it, so its convs keep the
FPN's names), then ``rfp_steps - 1`` rounds: ASPP-compressed pyramid
levels fed back into a fresh backbone (``rfp_modules.{i}``) over the input
images, the shared FPN over its outputs, fused with the previous round by
a zero-init sigmoid gate (``rfp_weight``) of the new levels. It is called
with the images as well as the first backbone's outputs
(``takes_images``; ``models/detectors.py`` ``extract_feat``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..utils.registry import NECKS
from .fpn import FPN


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
