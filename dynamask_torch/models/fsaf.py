"""FSAF, the Feature Selective Anchor-Free detector (port of
``dynamask_tpu/models/fsaf.py``): a ``RetinaHead`` with one anchor a
location (the stride cell), TBLR box regression (``TBLRBBoxCoder``), the
``CenterRegionAssigner``'s positives, and online feature selection: each
GT trains through the level where its positives' mean loss (focal plus
``-log IoU``, detached) is least, 1e6 for a level it has none on.

A positive of another level keeps its negative-class terms but drops its
label's column, and its regression (``drop`` / ``keep``, JAX ``fsaf.py:
163-172``); the shadowed (anchor, GT label) entries are zero; both losses
are over the batch's kept positives, or its negatives where it has none.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..core.assigners import CenterRegionAssigner
from ..core.coders import TBLRBBoxCoder
from ..utils.registry import DETECTORS
from .gfl import aligned_iou
from .losses import focal_elementwise
from .single_stage import (DenseDetector, dense_get_dets, flatten_levels,
                           one_hot_fg)


def tblr_energy(reg: torch.Tensor) -> torch.Tensor:
    """The positive TBLR distances of the head's raw output (JAX clamps
    the ReLU at 1e-4)."""
    return F.relu(reg).clamp(min=1e-4)


@DETECTORS.register_module()
class FSAF(DenseDetector):
    """mmdet's ``FSAF`` detector over a ``RetinaHead`` with one anchor, as
    JAX's."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, num_classes: int = 80,
                 strides=(8, 16, 32, 64, 128), tblr_normalizer: float = 4.0,
                 pos_scale: float = 0.2, neg_scale: float = 0.2,
                 min_pos_iof: float = 0.01, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.anchor_generator = AnchorGenerator(strides, (1.0,),
                                                scales=(1.0,))
        self.coder = TBLRBBoxCoder(tblr_normalizer)
        self.assigner = CenterRegionAssigner(pos_scale, neg_scale,
                                             min_pos_iof)
        self.focal = (focal_gamma, focal_alpha)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """``loss_cls`` and ``loss_bbox`` of one padded batch; nothing is
        drawn."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            mlvl = self.anchor_generator.grid_anchors(sizes, feats[0].device)
            anchors = torch.cat(mlvl)
            level = torch.cat([torch.full((a.shape[0],), i,
                                          device=anchors.device)
                               for i, a in enumerate(mlvl)])
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            dt = flat_cls.dtype
            level_onehot = F.one_hot(level, len(mlvl)).to(dt)      # (A, L)
            flat_reg = tblr_energy(flatten_levels(bbox_preds, 4))
            gt_boxes = batch['gt_boxes']
            num_gts = gt_boxes.shape[1]
            cls_l, reg_l, num_pos, num_neg = 0, 0, 0, 0
            for i in range(flat_cls.shape[0]):
                glabels = batch['gt_labels'][i].long()
                a, shadowed = self.assigner.assign_with_shadow(
                    anchors, valid[i], gt_boxes[i], batch['gt_valid'][i],
                    glabels)
                pos = (a.gt_inds > 0).float()
                include = (a.gt_inds >= 0).float()
                gt_idx = (a.gt_inds - 1).clamp(0, num_gts - 1)
                onehot = one_hot_fg(a.labels.clamp(min=0), pos > 0,
                                    self.num_classes)
                cls_el = focal_elementwise(flat_cls[i], onehot, *self.focal)
                # the shadowed (anchor, GT label) entries take no part
                glab = F.one_hot(glabels.clamp(0, self.num_classes - 1),
                                 self.num_classes).to(dt)
                shadow_w = 1.0 - (shadowed.to(dt) @ glab).clamp(0, 1)
                cls_el = cls_el * shadow_w * include[:, None]
                decoded = self.coder.decode(anchors, flat_reg[i])
                iou = aligned_iou(decoded, gt_boxes[i][gt_idx])
                reg_el = -torch.log(iou.clamp(min=1e-6)) * pos
                # each GT's mean anchor loss a level, its least level kept
                gt_onehot = F.one_hot(gt_idx, num_gts).to(dt) * pos[:, None]
                el_sum = cls_el.sum(-1) + reg_el
                per = (gt_onehot * el_sum[:, None]).t() @ level_onehot
                cnt = gt_onehot.t() @ level_onehot
                mean_loss = torch.where(cnt > 0, per / cnt.clamp(min=1.0),
                                        1e6)
                best_level = mean_loss.detach().argmin(1)
                keep = (best_level[gt_idx] == level).float() * pos
                drop = pos - keep
                cls_l = cls_l + (cls_el * (1.0 - drop[:, None] *
                                           onehot)).sum()
                reg_l = reg_l + (reg_el * keep).sum()
                num_pos = num_pos + keep.sum()
                num_neg = num_neg + (include - pos).sum()
            total = torch.as_tensor(num_pos)
            avg = torch.where(total > 0, total,
                              torch.as_tensor(num_neg)).clamp(min=1.0)
            return {'loss_cls': cls_l / avg, 'loss_bbox': reg_l / avg}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('get_dets'):
            mlvl = self.anchor_generator.grid_anchors(
                [tuple(f.shape[-2:]) for f in feats], feats[0].device)
            return dense_get_dets(
                cls_scores, bbox_preds, mlvl, batch, self.num_classes,
                lambda a, reg: self.coder.decode(a, tblr_energy(reg)),
                rescale=rescale, **self.test_cfg)

