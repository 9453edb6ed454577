"""Feature Pyramid Network (port of ``dynamask_tpu/models/fpn.py:20-112``):
1×1 laterals over the backbone levels ``start_level`` to ``end_level``,
nearest ×2 top-down adds, 3×3 output convs, and extra levels by stride-2
max pool (``num_outs=5`` over four laterals gives P6) or by stride-2 3×3
convs (``add_extra_convs``: on the last used backbone level, ``'on_input'``
or ``True`` with ``extra_convs_on_inputs``, or on the last output,
``'on_output'``; ``relu_before_extra_convs`` puts a ReLU before every
extra conv but the first). The JAX form bands the big levels' convs across
W (``conv_space_to_batch_w``, a TPU layout rewrite); the port runs the
plain convs.

``norm='gn'`` (the gn and gn+ws configs' ``norm_cfg``) drops the convs'
biases and puts a GroupNorm of ``gn_groups`` after each lateral, output and
extra conv, in JAX's order on its norm path: lateral conv, GN, the top-down
adds on the normalised laterals, output conv, GN; ``norm='bn'`` (the
crop640 RetinaNet's) a flax-like BatchNorm in the same places.
``no_norm_on_lateral`` leaves the laterals without norm, and without a
bias as in JAX (``fpn.py:58-63``). The extra convs are mmdet's
``fpn_convs.{n}`` for n from the number of laterals on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import NECKS
from .layers import ConvModule


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 norm: Optional[str] = None, gn_groups: int = 32,
                 no_norm_on_lateral: bool = False, start_level: int = 0,
                 end_level: int = -1,
                 add_extra_convs: Union[bool, str] = False,
                 extra_convs_on_inputs: bool = True,
                 relu_before_extra_convs: bool = False):
        super().__init__()
        if norm not in (None, 'gn', 'bn'):
            raise NotImplementedError(f'FPN norm {norm!r}')
        if add_extra_convs not in (False, True, 'on_input', 'on_output'):
            raise NotImplementedError(f'FPN add_extra_convs '
                                      f'{add_extra_convs!r}')
        self.num_outs = num_outs
        self.start_level = start_level
        self.end_level = len(in_channels) if end_level == -1 else end_level
        self.on_input = (add_extra_convs == 'on_input' or (
            add_extra_convs is True and extra_convs_on_inputs))
        self.relu_before_extra_convs = relu_before_extra_convs
        used = list(in_channels[start_level:self.end_level])
        self.num_laterals = len(used)
        gn = gn_groups if norm == 'gn' else None
        bn = norm == 'bn'
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out_channels, 1, bias=norm is None,
                        gn_groups=None if no_norm_on_lateral else gn,
                        bn=bn and not no_norm_on_lateral)
             for c in used])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out_channels, out_channels, 3, padding=1,
                        gn_groups=gn, bn=bn)
             for _ in used])
        if add_extra_convs:
            for i in range(num_outs - len(used)):
                cin = used[-1] if i == 0 and self.on_input else out_channels
                self.fpn_convs.append(ConvModule(
                    cin, out_channels, 3, padding=1, stride=2,
                    bias=norm is None, gn_groups=gn, bn=bn))

    def forward(self, inputs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        used = list(inputs[self.start_level:self.end_level])
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, used)]
        for i in range(len(laterals) - 1, 0, -1):
            up = F.interpolate(laterals[i], scale_factor=2, mode='nearest')
            h, w = laterals[i - 1].shape[-2:]
            laterals[i - 1] = laterals[i - 1] + up[:, :, :h, :w]
        outs = [self.fpn_convs[i](x) for i, x in enumerate(laterals)]
        extra = self.fpn_convs[self.num_laterals:]
        if not len(extra):
            for _ in range(self.num_outs - len(outs)):
                outs.append(outs[-1][:, :, ::2, ::2])   # max_pool(1, stride 2)
            return tuple(outs)
        src = used[-1] if self.on_input else outs[-1]
        for i, conv in enumerate(extra):
            outs.append(conv(F.relu(src) if i and self.relu_before_extra_convs
                             else src))
            src = outs[-1]
        return tuple(outs)
