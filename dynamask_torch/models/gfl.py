"""GFL, the Generalized Focal Loss detector (port of ``dynamask_tpu/
models/gfl.py``): an ATSS-assigned anchor head (one square anchor a
location) whose regression branch predicts, for each side, a distribution
over ``reg_max + 1`` integer distances in stride units, decoded by its
expectation (:func:`integral_decode`), and whose class branch is a joint
class-quality score.

The losses are JAX's (``gfl.py:185-229``): Quality Focal Loss against the
IoU of the decoded, detached prediction with its GT over the batch's
positives, GIoU and Distribution Focal Loss weighted by the detached max
class sigmoid over the batch's sum of those weights. The assignment is the
port's ``ATSSAssigner`` (its biased deviation, ROADMAP.md queue 3, 3ac).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..core.assigners import ATSSAssigner
from ..core.bbox_transforms import distance2bbox
from ..core.fp16 import at_least_f32
from ..utils.registry import DETECTORS, HEADS
from .atss import Scale
from .losses import distribution_focal_loss, iou_loss, quality_focal_loss
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv,
                           dense_get_dets, flatten_levels, head_conv,
                           one_hot_fg)


def integral_decode(logits: torch.Tensor, reg_max: int) -> torch.Tensor:
    """(..., 4 * (reg_max + 1)) logits -> (..., 4) distances: each side's
    softmax expectation over the bins 0..reg_max, in fp32."""
    p = F.softmax(at_least_f32(logits).reshape(logits.shape[:-1] +
                                               (4, reg_max + 1)), -1)
    return p @ torch.arange(reg_max + 1, dtype=p.dtype, device=p.device)


def bbox2distance(points: torch.Tensor, bbox: torch.Tensor, max_dis: float,
                  eps: float = 0.1) -> torch.Tensor:
    """(l, t, r, b) distances of (x, y) ``points`` to the sides of
    ``bbox``, clipped to [0, max_dis - eps]."""
    return torch.stack([points[..., 0] - bbox[..., 0],
                        points[..., 1] - bbox[..., 1],
                        bbox[..., 2] - points[..., 0],
                        bbox[..., 3] - points[..., 1]], -1).clamp(
                            0, max_dis - eps)


def aligned_iou(a: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The IoU of each (..., 4) box pair."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * \
        (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * \
        (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / (area_a + area_b - inter).clamp(min=eps)


def anchor_center(anchors: torch.Tensor) -> torch.Tensor:
    return torch.stack([(anchors[..., 0] + anchors[..., 2]) * 0.5,
                        (anchors[..., 1] + anchors[..., 3]) * 0.5], -1)


@HEADS.register_module()
class GFLHead(nn.Module):
    """The GN towers (biased convs, as JAX's), ``gfl_cls`` (the prior
    bias) and ``gfl_reg`` (4 x (reg_max + 1) logits) times the level's
    ``Scale``, in fp32."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_levels: int = 5, reg_max: int = 16,
                 gn_groups: int = 32):
        super().__init__()
        self.num_classes = num_classes
        self.reg_max = reg_max
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], gn_groups=gn_groups)
             for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], gn_groups=gn_groups)
             for i in range(stacked_convs)])
        self.gfl_cls = head_conv(chans[-1], num_classes, bias_init=PRIOR_BIAS)
        self.gfl_reg = head_conv(chans[-1], 4 * (reg_max + 1))
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out = [], []
        for x, scale in zip(feats, self.scales):
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.gfl_cls(c))
            reg_out.append(scale(at_least_f32(self.gfl_reg(r))))
        return cls_out, reg_out


@DETECTORS.register_module()
class GFL(DenseDetector):
    """mmdet's ``GFL`` detector, as JAX's."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: GFLHead, num_classes: int = 80,
                 strides=(8, 16, 32, 64, 128), octave_base_scale: float = 8.0,
                 anchor_ratios=(1.0,), reg_max: int = 16,
                 assigner_topk: int = 9, loss_dfl_weight: float = 0.25,
                 loss_bbox_weight: float = 2.0, nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.6,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.strides = tuple(strides)
        self.anchor_generator = AnchorGenerator(strides, anchor_ratios,
                                                scales=(octave_base_scale,))
        self.reg_max = reg_max
        self.assigner = ATSSAssigner(assigner_topk)
        self.loss_dfl_weight = loss_dfl_weight
        self.loss_bbox_weight = loss_bbox_weight

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_bbox`` and ``loss_dfl`` of one padded batch;
        nothing is drawn."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            mlvl = self.anchor_generator.grid_anchors(sizes, feats[0].device)
            anchors = torch.cat(mlvl)
            stride = torch.cat([torch.full((a.shape[0],), float(s),
                                           device=anchors.device)
                                for a, s in zip(mlvl, self.strides)])
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            nbins = self.reg_max + 1
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            flat_reg = flatten_levels(bbox_preds, 4 * nbins)
            centers = anchor_center(anchors) / stride[:, None]
            gt_boxes = batch['gt_boxes']
            cls_l, bbox_l, dfl_l, num_pos, wt_sum = 0, 0, 0, 0, 0
            for i in range(flat_cls.shape[0]):
                a = self.assigner(anchors, valid[i], gt_boxes[i],
                                  batch['gt_valid'][i], batch['gt_labels'][i],
                                  num_level_anchors=[m.shape[0]
                                                     for m in mlvl])
                pos = (a.gt_inds > 0).float()
                tgt = gt_boxes[i][(a.gt_inds - 1).clamp(
                    0, gt_boxes.shape[1] - 1)] / stride[:, None]
                decoded = distance2bbox(centers, integral_decode(
                    flat_reg[i], self.reg_max))
                score = aligned_iou(decoded.detach(), tgt) * pos
                wt = torch.sigmoid(flat_cls[i].detach()).max(-1).values * pos
                onehot = one_hot_fg(a.labels.clamp(min=0), pos > 0,
                                    self.num_classes)
                cls_l = cls_l + quality_focal_loss(
                    flat_cls[i], onehot, score,
                    weight=(a.gt_inds >= 0).float()[:, None], avg_factor=1.0)
                bbox_l = bbox_l + iou_loss(decoded, tgt, mode='giou',
                                           weight=wt, avg_factor=1.0)
                dfl_l = dfl_l + distribution_focal_loss(
                    flat_reg[i].reshape(-1, 4, nbins),
                    bbox2distance(centers, tgt, self.reg_max),
                    weight=wt[:, None] / 4.0, avg_factor=1.0)
                num_pos = num_pos + pos.sum()
                wt_sum = wt_sum + wt.sum()
            avg = torch.as_tensor(num_pos).clamp(min=1.0)
            wavg = torch.as_tensor(wt_sum).clamp(min=1e-6)
            return {'loss_cls': cls_l / avg,
                    'loss_bbox': self.loss_bbox_weight * bbox_l / wavg,
                    'loss_dfl': self.loss_dfl_weight * dfl_l / wavg}

    def decode(self, priors: torch.Tensor, reg: torch.Tensor
               ) -> torch.Tensor:
        """(..., 3) [cx, cy, stride] priors and their distribution logits
        -> boxes."""
        return distance2bbox(priors[..., :2], integral_decode(
            reg, self.reg_max) * priors[..., 2:3])

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('get_dets'):
            mlvl = self.anchor_generator.grid_anchors(
                [tuple(f.shape[-2:]) for f in feats], feats[0].device)
            priors = [torch.cat([anchor_center(a), torch.full_like(
                a[:, :1], float(s))], 1) for a, s in zip(mlvl, self.strides)]
            return dense_get_dets(cls_scores, bbox_preds, priors, batch,
                                  self.num_classes, self.decode,
                                  rescale=rescale,
                                  reg_channels=4 * (self.reg_max + 1),
                                  **self.test_cfg)
