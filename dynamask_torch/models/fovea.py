"""FoveaBox (port of ``dynamask_tpu/models/fovea.py``): an anchor-free
head whose GTs go to the levels of their scale range, whose positives are
the cells inside each GT's sigma-shrunk fovea (the smallest GT where they
overlap: ``argmin`` over the areas, the first of equal ones), and whose
regression is the log of the (x1, y1, x2, y2) distances over the level's
base edge, clipped to [1/16, 16], under SmoothL1.

``with_deform`` (the ``fovea_align`` configs) adds the FeatureAlign step:
a 3x3 exact-gather DCN in ``deform_groups`` groups on the raw level
(``layers.DeformConv2d``), its offsets a bias-free 1x1 conv of the exp of
the box prediction, then a 3x3 and a 1x1 conv of 4x the width; GN sits in
the towers of the configs that name it. Focal over every cell over the
batch's positives plus its images; SmoothL1 over its positives.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.fp16 import at_least_f32
from ..utils.registry import DETECTORS, HEADS
from .layers import DeformConv2d
from .losses import focal_elementwise, smooth_l1_elementwise
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv,
                           dense_get_dets, flatten_levels, head_conv,
                           one_hot_fg)

INF = 1e8


class FeatureAlign(nn.Module):
    """mmdet's ``FeatureAlign``: ``conv_offset`` (1x1, bias-free, N(0,
    0.1) as JAX's ``feature_adaption_offset``) of the 4-channel box shape,
    then ``conv_adaption`` (the DCN) and a ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 4):
        super().__init__()
        self.conv_offset = nn.Conv2d(4, deform_groups * 18, 1, bias=False)
        self.conv_offset.init_rule = 0.1
        self.conv_adaption = DeformConv2d(in_channels, out_channels, 3,
                                          deform_groups)

    def forward(self, x: torch.Tensor, shape: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv_adaption(x, self.conv_offset(shape)))


@HEADS.register_module()
class FoveaHead(nn.Module):
    """The reg tower and ``conv_reg`` (4 raw log-space outputs); the cls
    tower (``stacked_convs`` 3x3 convs, or with ``with_deform`` the
    FeatureAlign, a 3x3 and a 1x1 conv of ``4 * feat_channels``) and
    ``conv_cls``; the tower convs bias-free under GN (``gn_groups``)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 with_deform: bool = False, deform_groups: int = 4,
                 gn_groups: Optional[int] = None):
        super().__init__()
        self.num_classes = num_classes
        bias = gn_groups is None
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], bias=bias, gn_groups=gn_groups)
             for i in range(stacked_convs)])
        self.conv_reg = head_conv(feat_channels, 4)
        if with_deform:
            self.feature_adaption = FeatureAlign(feat_channels, feat_channels,
                                                 deform_groups)
            wide = 4 * feat_channels
            self.cls_convs = nn.ModuleList([
                TowerConv(feat_channels, wide, bias=bias, gn_groups=gn_groups),
                TowerConv(wide, wide, bias=bias, gn_groups=gn_groups,
                          kernel=1)])
        else:
            wide = feat_channels
            self.cls_convs = nn.ModuleList(
                [TowerConv(chans[i], chans[i + 1], bias=bias,
                           gn_groups=gn_groups)
                 for i in range(stacked_convs)])
        self.conv_cls = head_conv(wide, num_classes, bias_init=PRIOR_BIAS)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out = [], []
        for x in feats:
            r = x
            for conv in self.reg_convs:
                r = conv(r)
            reg = self.conv_reg(r)
            c = (self.feature_adaption(x, torch.exp(at_least_f32(reg)))
                 if hasattr(self, 'feature_adaption') else x)
            for conv in self.cls_convs:
                c = conv(c)
            cls_out.append(self.conv_cls(c))
            reg_out.append(reg)
        return cls_out, reg_out


def fovea_targets_level(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, featmap_size, stride: float,
                        base_len: float, scale_range, sigma: float,
                        num_classes: int):
    """One image's dense targets on one level (JAX ``fovea_targets_level``)
    -> labels (H*W,) (``num_classes`` on a negative), the (H*W, 4)
    log-space targets (0 off the positives), the positive mask."""
    h, w = featmap_size
    areas = torch.sqrt(((gt_boxes[:, 2] - gt_boxes[:, 0]) *
                        (gt_boxes[:, 3] - gt_boxes[:, 1])).clamp(min=0))
    hit = (areas >= scale_range[0]) & (areas <= scale_range[1]) & \
        gt_valid.bool()
    gs = gt_boxes / stride
    half_w = 0.5 * (gs[:, 2] - gs[:, 0])
    half_h = 0.5 * (gs[:, 3] - gs[:, 1])
    px1 = torch.ceil(gs[:, 0] + (1 - sigma) * half_w - 0.5).clamp(0, w - 1)
    px2 = torch.floor(gs[:, 0] + (1 + sigma) * half_w - 0.5).clamp(0, w - 1)
    py1 = torch.ceil(gs[:, 1] + (1 - sigma) * half_h - 0.5).clamp(0, h - 1)
    py2 = torch.floor(gs[:, 1] + (1 + sigma) * half_h - 0.5).clamp(0, h - 1)
    dev = gt_boxes.device
    iy, ix = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    ix, iy = ix.reshape(-1, 1), iy.reshape(-1, 1)
    member = (ix >= px1[None]) & (ix <= px2[None]) & (iy >= py1[None]) & \
        (iy <= py2[None]) & hit[None]
    area_mat = torch.where(member, (areas ** 2)[None], INF)
    gt_idx = area_mat.argmin(-1)
    pos = area_mat.min(-1).values < INF
    labels = torch.where(pos, gt_labels.long()[gt_idx], num_classes)
    tgt = gt_boxes[gt_idx]
    x_pt, y_pt = (ix[:, 0] + 0.5) * stride, (iy[:, 0] + 0.5) * stride
    t = torch.stack([(x_pt - tgt[:, 0]) / base_len,
                     (y_pt - tgt[:, 1]) / base_len,
                     (tgt[:, 2] - x_pt) / base_len,
                     (tgt[:, 3] - y_pt) / base_len], -1)
    bbox_t = torch.where(pos[:, None], torch.log(t.clamp(1. / 16, 16.)), 0.0)
    return labels, bbox_t, pos


def fovea_priors(sizes, strides, base_edges, device=None):
    """Per level the (H*W, 3) [x, y, base edge] of each cell's centre."""
    out = []
    for (h, w), s, base in zip(sizes, strides, base_edges):
        iy, ix = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing='ij')
        out.append(torch.stack([(ix.reshape(-1) + 0.5) * s,
                                (iy.reshape(-1) + 0.5) * s,
                                torch.full((h * w,), float(base),
                                           device=device)], -1))
    return out


def fovea_decode(priors: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """[x, y, base edge] priors and log-space distances -> boxes."""
    d = torch.exp(reg) * priors[..., 2:3]
    return torch.stack([priors[..., 0] - d[..., 0], priors[..., 1] - d[..., 1],
                        priors[..., 0] + d[..., 2],
                        priors[..., 1] + d[..., 3]], -1)


@DETECTORS.register_module()
class FOVEA(DenseDetector):
    """mmdet's ``FOVEA`` detector, as JAX's."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: FoveaHead, num_classes: int = 80,
                 strides=(8, 16, 32, 64, 128),
                 base_edge_list=(16, 32, 64, 128, 256),
                 scale_ranges=((8, 32), (16, 64), (32, 128), (64, 256),
                               (128, 512)),
                 sigma: float = 0.4, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, smoothl1_beta: float = 0.11,
                 loss_bbox_weight: float = 1.0, nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.strides = tuple(strides)
        self.base_edge_list = tuple(base_edge_list)
        self.scale_ranges = tuple(tuple(r) for r in scale_ranges)
        self.sigma = sigma
        self.focal = (focal_gamma, focal_alpha)
        self.smoothl1_beta = smoothl1_beta
        self.loss_bbox_weight = loss_bbox_weight

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """``loss_cls`` and ``loss_bbox`` of one padded batch; nothing is
        drawn, every cell takes part (no valid flags, as in JAX)."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            flat_reg = flatten_levels(bbox_preds, 4)
            b = flat_cls.shape[0]
            cls_l, reg_l, num_pos = 0, 0, 0
            for i in range(b):
                labels, tgts, pos = zip(*[fovea_targets_level(
                    batch['gt_boxes'][i], batch['gt_labels'][i],
                    batch['gt_valid'][i], size, float(s), float(base), rng,
                    self.sigma, self.num_classes)
                    for size, s, base, rng in zip(
                        sizes, self.strides, self.base_edge_list,
                        self.scale_ranges)])
                pos = torch.cat(pos)
                onehot = one_hot_fg(torch.cat(labels), pos, self.num_classes)
                cls_l = cls_l + focal_elementwise(flat_cls[i], onehot,
                                                  *self.focal).sum()
                reg_l = reg_l + (smooth_l1_elementwise(
                    flat_reg[i], torch.cat(tgts), self.smoothl1_beta) *
                    pos[:, None]).sum()
                num_pos = num_pos + pos.sum()
            total = torch.as_tensor(num_pos).float()
            return {'loss_cls': cls_l / (total + b).clamp(min=1.0),
                    'loss_bbox': self.loss_bbox_weight * reg_l /
                    total.clamp(min=1.0)}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Boxes clipped to ``w - 1``, ``h - 1``, as JAX's."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('get_dets'):
            priors = fovea_priors([tuple(f.shape[-2:]) for f in feats],
                                  self.strides, self.base_edge_list,
                                  feats[0].device)
            return dense_get_dets(cls_scores, bbox_preds, priors, batch,
                                  self.num_classes, fovea_decode,
                                  rescale=rescale, clip_inset=1.0,
                                  **self.test_cfg)
