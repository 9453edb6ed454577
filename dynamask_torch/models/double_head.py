"""Double-Head R-CNN (port of ``dynamask_tpu/models/double_head.py``:
``BasicResBlock``, ``DoubleConvFCBBoxHead``, ``scale_rois`` and
``DoubleHeadRoIHead``).

The classification branch reads the 7×7 crop of each RoI through fcs; the
regression branch reads a second crop of the RoI enlarged
``reg_roi_scale_factor`` times about its centre, through a residual tower
(a ``BasicResBlock`` and ``num_convs`` Bottlenecks) and a global average
pool. The box branch takes both crops in one K2 launch over the RoIs
and the enlarged RoIs stacked (one K4 launch in the backward). As in JAX, the enlarged RoIs are routed to their FPN level by
their enlarged size, where mmdet routes the original RoI and rescales it
after (ROADMAP.md queue 3, 3u).

Two places part from mmdet, as JAX does (3v): every BatchNorm of the tower
normalises with its running statistics in training too (mmdet's train on
the batch's), and ``conv_identity`` carries a bias (mmdet's has none under
its BatchNorm). mmdet's names: ``res_block.{conv1,conv2,conv_identity}.
{conv,bn}``, ``conv_branch.{i}.{conv1..3,bn1..3}``, ``fc_branch.{i}``,
``fc_cls``, ``fc_reg``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.registry import HEADS
from .layers import BatchNorm2d, to_nchw
from .resnet import Bottleneck
from .roi_head import StandardRoIHead


class ConvBN(nn.Module):
    """A conv under ``.conv`` and its BatchNorm under ``.bn`` (mmcv's
    ``ConvModule`` with ``norm_cfg=BN``, no activation)."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 padding: int = 0, bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, padding=padding,
                              bias=bias)
        self.bn = BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class BasicResBlock(nn.Module):
    """3×3 conv + 1×1 conv on the main path, a 1×1 projection beside it,
    ReLU of the sum (JAX ``double_head.py:23-53``)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = ConvBN(in_channels, in_channels, 3, padding=1)
        self.conv2 = ConvBN(in_channels, out_channels, 1)
        self.conv_identity = ConvBN(in_channels, out_channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h + self.conv_identity(x))


@HEADS.register_module()
class DoubleConvFCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_feat_size: int = 7, num_convs: int = 4,
                 num_fcs: int = 2, conv_out_channels: int = 1024,
                 fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.res_block = BasicResBlock(in_channels, conv_out_channels)
        self.conv_branch = nn.ModuleList(
            Bottleneck(conv_out_channels, conv_out_channels // 4,
                       zero_init_residual=False) for _ in range(num_convs))
        self.fc_branch = nn.ModuleList(
            nn.Linear(in_channels * roi_feat_size ** 2 if i == 0
                      else fc_out_channels, fc_out_channels)
            for i in range(num_fcs))
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(conv_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def train(self, mode: bool = True):
        """The tower's BatchNorms stay on their running statistics (3v)."""
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
        return self

    def forward(self, x_cls: torch.Tensor, x_reg: torch.Tensor):
        """(N, P, P, C) NHWC crops of the RoIs and of the enlarged RoIs ->
        (cls_logits (N, C+1), deltas (N, 4*C) or (N, 4)). The first fc
        reads the crop in mmdet's CHW order."""
        h = self.res_block(to_nchw(x_reg))
        for block in self.conv_branch:
            h = block(h)
        deltas = self.fc_reg(h.mean((2, 3)))
        f = x_cls.permute(0, 3, 1, 2).reshape(x_cls.shape[0], -1)
        for fc in self.fc_branch:
            f = F.relu(fc(f))
        return self.fc_cls(f), deltas


def scale_rois(rois: torch.Tensor, factor: float) -> torch.Tensor:
    """xyxy RoIs enlarged ``factor`` times about their centres."""
    c = (rois[:, :2] + rois[:, 2:4]) * 0.5
    half = (rois[:, 2:4] - rois[:, :2]) * (0.5 * factor)
    return torch.cat([c - half, c + half], -1)


@HEADS.register_module()
class DoubleHeadRoIHead(StandardRoIHead):
    """The standard head whose box forward pulls the two crops."""

    aug_test_refusal = ('its box head takes two crops, and JAX\'s aug_test '
                        'gives it one (a TypeError)')

    def __init__(self, bbox_head: nn.Module, mask_head=None,
                 reg_roi_scale_factor: float = 1.3, **common):
        super().__init__(bbox_head, mask_head, **common)
        self.reg_roi_scale_factor = reg_roi_scale_factor

    def _bbox_forward(self, feats, rois, roi_batch):
        """Both crops in one extract of 2N rows (one K2 launch, one K4 in
        the backward): the RoIs, then the enlarged RoIs, each routed by
        its own size (ROADMAP.md queue 3, 3u)."""
        n = rois.shape[0]
        crops = self._extract(
            feats, torch.cat([rois, scale_rois(rois,
                                               self.reg_roi_scale_factor)]),
            roi_batch.repeat(2), self.bbox_roi_out)
        return self.bbox_head(crops[:n], crops[n:])
