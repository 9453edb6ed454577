"""ATSS (port of ``dynamask_tpu/models/atss.py``): one anchor a location
(``octave_base_scale`` 8, one ratio), the GN tower of FCOS with a learnable
``Scale`` a level on the raw deltas, a centerness branch, the adaptive
training sample selection (``core.assigners.ATSSAssigner``), and GIoU
regression weighted by the centerness target.

The losses are fixed as in JAX (``atss.py:160-185``): focal at gamma 2 and
alpha 0.25, GIoU at weight 2 over the batch's centerness sum, centerness
BCE; the builder refuses configs that set others.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..core.assigners import ATSSAssigner
from ..core.bbox_transforms import delta2bbox
from ..utils.registry import DETECTORS, HEADS
from .losses import (binary_cross_entropy_with_logits, focal_elementwise,
                     iou_loss)
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv,
                           dense_get_dets, flatten_levels, head_conv,
                           one_hot_fg)


class Scale(nn.Module):
    """A learnable scalar factor (mmcv's ``Scale``: ``scales.{i}.scale``),
    initialised to 1."""

    def __init__(self, scale: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))
        self.init_fill = {'scale': float(scale)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


@HEADS.register_module()
class ATSSHead(nn.Module):
    """The GN tower (its convs keep a bias under GN, as JAX's do), then
    ``atss_cls`` (the prior bias), ``atss_reg`` times the level's scale
    (no exp) and ``atss_centerness`` from the reg tower."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_levels: int = 5, num_anchors: int = 1,
                 gn_groups: int = 32):
        super().__init__()
        self.num_classes = num_classes
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], gn_groups=gn_groups)
             for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], gn_groups=gn_groups)
             for i in range(stacked_convs)])
        self.atss_cls = head_conv(chans[-1], num_anchors * num_classes,
                                  bias_init=PRIOR_BIAS)
        self.atss_reg = head_conv(chans[-1], num_anchors * 4)
        self.atss_centerness = head_conv(chans[-1], num_anchors)
        self.scales = nn.ModuleList([Scale() for _ in range(num_levels)])

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, cent_out = [], [], []
        for x, scale in zip(feats, self.scales):
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.atss_cls(c))
            reg_out.append(scale(self.atss_reg(r).float()))
            cent_out.append(self.atss_centerness(r))
        return cls_out, reg_out, cent_out


def centerness_target(centers: torch.Tensor, gts: torch.Tensor
                      ) -> torch.Tensor:
    """sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b)) of each (x, y)
    centre to its (x1, y1, x2, y2) GT, clipped to [0, 1]."""
    left = centers[..., 0] - gts[..., 0]
    right = gts[..., 2] - centers[..., 0]
    top = centers[..., 1] - gts[..., 1]
    bottom = gts[..., 3] - centers[..., 1]
    lr = torch.minimum(left, right) / torch.maximum(left, right).clamp(
        min=1e-6)
    tb = torch.minimum(top, bottom) / torch.maximum(top, bottom).clamp(
        min=1e-6)
    return torch.sqrt((lr * tb).clamp(0, 1))


def atss_centerness_target(anchors: torch.Tensor, gts: torch.Tensor
                           ) -> torch.Tensor:
    """The centerness target of each anchor's centre to its GT (JAX
    ``atss_centerness_target``)."""
    return centerness_target((anchors[..., :2] + anchors[..., 2:]) * 0.5,
                             gts)


@DETECTORS.register_module()
class ATSS(DenseDetector):
    """mmdet's ``ATSS`` detector, as JAX's ``ATSS``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, num_classes: int = 80,
                 strides=(8, 16, 32, 64, 128), octave_base_scale: float = 8.0,
                 anchor_ratios=(1.0,), target_means=(0., 0., 0., 0.),
                 target_stds=(0.1, 0.1, 0.2, 0.2), assigner_topk: int = 9,
                 nms_pre: int = 1000, score_thr: float = 0.05,
                 nms_iou_thr: float = 0.6, max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.anchor_generator = AnchorGenerator(strides, anchor_ratios,
                                                scales=(octave_base_scale,))
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.assigner = ATSSAssigner(assigner_topk)

    def decode(self, anchors, deltas):
        return delta2bbox(anchors, deltas, self.target_means,
                          self.target_stds)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The three losses of one padded batch; nothing is drawn."""
        feats, (cls_scores, bbox_preds, cent_preds) = self.head(batch)
        with record_function('loss'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            mlvl = self.anchor_generator.grid_anchors(sizes, feats[0].device)
            anchors = torch.cat(mlvl)
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            flat_reg = flatten_levels(bbox_preds, 4)
            flat_cent = flatten_levels(cent_preds, 1)[..., 0]
            gt_boxes = batch['gt_boxes']
            cls_l, iou_l, cent_l, num_pos, cent_sum = 0, 0, 0, 0, 0
            for i in range(flat_cls.shape[0]):
                a = self.assigner(anchors, valid[i], gt_boxes[i],
                                  batch['gt_valid'][i], batch['gt_labels'][i],
                                  num_level_anchors=[m.shape[0]
                                                     for m in mlvl])
                pos = a.gt_inds > 0
                onehot = one_hot_fg(a.labels.clamp(min=0), pos,
                                    self.num_classes)
                cls_l = cls_l + (focal_elementwise(flat_cls[i], onehot) *
                                 (a.gt_inds >= 0)[:, None]).sum()
                tgt = gt_boxes[i][(a.gt_inds - 1).clamp(
                    0, gt_boxes.shape[1] - 1)]
                cent_t = atss_centerness_target(anchors, tgt)
                pred = self.decode(anchors, flat_reg[i])
                w = pos.float() * cent_t
                iou_l = iou_l + iou_loss(pred, tgt, mode='giou', weight=w,
                                         avg_factor=1.0)
                cent_l = cent_l + (binary_cross_entropy_with_logits(
                    flat_cent[i], cent_t) * pos).sum()
                num_pos = num_pos + pos.sum()
                cent_sum = cent_sum + w.sum()
            avg = torch.as_tensor(num_pos).float().clamp(min=1.0)
            cavg = torch.as_tensor(cent_sum).clamp(min=1e-6)
            return {'loss_cls': cls_l / avg, 'loss_bbox': 2.0 * iou_l / cavg,
                    'loss_centerness': cent_l / avg}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Scores are the class sigmoid times the centerness sigmoid;
        :func:`~dynamask_torch.models.single_stage.dense_get_dets` over
        the anchors."""
        feats, (cls_scores, bbox_preds, cent_preds) = self.head(batch)
        with record_function('get_dets'):
            mlvl = self.anchor_generator.grid_anchors(
                [tuple(f.shape[-2:]) for f in feats], feats[0].device)
            return dense_get_dets(cls_scores, bbox_preds, mlvl, batch,
                                  self.num_classes, self.decode, cent_preds,
                                  rescale=rescale, **self.test_cfg)
