"""Mask Scoring R-CNN's RoI head (port of ``dynamask_tpu/models/
mask_scoring.py``: ``MaskIoUHead`` :26, ``mask_iou_target`` :58,
``MaskScoringRoIHead`` :73).

Mask R-CNN's box and mask branches, and a MaskIoU head on the 14x14 mask
features beside the 2x2-max-pooled mask prediction (257 channels at the
configs' 256): four 3x3 convs (the last at stride 2) and three fcs to an
IoU a class. Training regresses the IoU of the binarised prediction with
the RoI's target, corrected by the GT's area outside the RoI as the JAX
package estimates it from the GT crops; inference crops the mask features
a second time (a third K2 launch an image; the profiler range
``mask_iou_branch``) and gives ``segm_scores``, the box score times the
predicted IoU. Names are mmdet's:
``mask_iou_head.{convs.i.conv, fcs.i, fc_mask_iou}``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.mask_targets import mask_targets_from_crops
from ..utils.registry import HEADS
from .fcn_mask_head import fcn_mask_loss, select_class_channel
from .layers import ConvModule, to_nchw
from .roi_head import StandardRoIHead


@HEADS.register_module()
class MaskIoUHead(nn.Module):
    """(N, C, s, s) mask features and (N, 2s, 2s) mask probabilities ->
    (N, num_classes) IoUs."""

    def __init__(self, num_convs: int = 4, num_fcs: int = 2,
                 in_channels: int = 256, conv_out_channels: int = 256,
                 fc_out_channels: int = 1024, roi_feat_size: int = 14,
                 num_classes: int = 80):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(in_channels + 1 if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1,
                       stride=2 if i == num_convs - 1 else 1)
            for i in range(num_convs))
        fcs, width = [], conv_out_channels * (roi_feat_size // 2) ** 2
        for _ in range(num_fcs):
            fc = nn.Linear(width, fc_out_channels)
            fc.init_rule = 'lecun'      # flax's default Dense init
            fcs.append(fc)
            width = fc_out_channels
        self.fcs = nn.ModuleList(fcs)
        self.fc_mask_iou = nn.Linear(width, num_classes)
        self.fc_mask_iou.init_rule = 0.01

    def forward(self, mask_feats: torch.Tensor,
                mask_probs: torch.Tensor) -> torch.Tensor:
        pooled = F.max_pool2d(mask_probs[:, None], 2, 2)
        x = torch.cat([mask_feats, pooled.to(mask_feats.dtype)], 1)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        return self.fc_mask_iou(x)


def mask_iou_target(pred_binary: torch.Tensor, targets: torch.Tensor,
                    full_areas_ratio: torch.Tensor) -> torch.Tensor:
    """The IoU of the binarised prediction and the target inside the RoI,
    the GT's area taken as its area inside over ``full_areas_ratio``."""
    inter = (pred_binary * targets).sum((1, 2))
    pred_area = pred_binary.sum((1, 2))
    gt_in_roi = targets.sum((1, 2))
    gt_full = gt_in_roi / full_areas_ratio.clamp(min=1e-6)
    return inter / (pred_area + gt_full - inter).clamp(min=1e-6)


@HEADS.register_module()
class MaskScoringRoIHead(StandardRoIHead):
    """``StandardRoIHead`` with an FCN mask head and a ``MaskIoUHead``
    (``mask_iou_head``); ``loss_iou_weight`` weighs the IoU loss."""

    def __init__(self, bbox_head, mask_head, mask_iou_head: MaskIoUHead,
                 loss_iou_weight: float = 0.5, **common):
        super().__init__(bbox_head, mask_head, **common)
        self.mask_iou_head = mask_iou_head
        self.loss_iou_weight = loss_iou_weight

    def _mask_forward_train(self, feats, sample, batch, gumbel_u=None,
                            generator=None):
        """Mask R-CNN's mask loss and the IoU loss: 0.5 (p - t)² of each
        valid positive's class, averaged over them and weighed (JAX
        ``mask_scoring.py:132-134``)."""
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        mask_feats = to_nchw(self._extract(feats, boxes, roi_batch,
                                           self.mask_roi_out))
        logits = self.mask_head(mask_feats)
        s = logits.shape[-1]
        targets = mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], s)
        losses = {'loss_mask': fcn_mask_loss(logits, targets, labels, valid,
                                             self.loss_mask_weight)}
        pred = torch.sigmoid(select_class_channel(logits, labels))
        binary = (pred > 0.5).float()
        # the GT's full area from its crop: the crop's pixels, each of the
        # window's area over the crop's
        crops = batch['gt_crops']
        b, g, cs = crops.shape[0], crops.shape[1], crops.shape[-1]
        crop_areas = crops.float().sum((2, 3)).reshape(b * g)
        win = batch['gt_windows'].reshape(b * g, 4).float()
        px = ((win[:, 2] - win[:, 0]) * (win[:, 3] - win[:, 1])).clamp(
            min=1e-6) / (cs * cs)
        flat_gt = roi_batch.long() * g + gt.long()
        full_area = crop_areas[flat_gt] * px[flat_gt]
        gt_in_roi = targets.sum((1, 2))
        roi_w = (boxes[:, 2] - boxes[:, 0]).clamp(min=1e-6)
        roi_h = (boxes[:, 3] - boxes[:, 1]).clamp(min=1e-6)
        cell = (roi_w * roi_h) / (s ** 2)
        ratio = (gt_in_roi * cell / full_area.clamp(min=1e-6)).clamp(1e-6,
                                                                     1.0)
        iou_target = mask_iou_target(binary, targets, ratio)
        iou_pred = self.mask_iou_head(mask_feats, pred)
        sel = iou_pred.gather(1, labels.long().clamp(
            0, iou_pred.shape[1] - 1)[:, None])[:, 0]
        w = valid.float()
        losses['loss_mask_iou'] = self.loss_iou_weight * (
            0.5 * (sel - iou_target) ** 2 * w).sum() / w.sum().clamp(min=1.0)
        return losses

    def simple_test(self, feats, proposals, proposal_valid, batch,
                    rescale: bool = True):
        """Mask R-CNN's results and ``segm_scores`` (B, D): each det's
        score times its class's predicted IoU, clipped to [0, 1]."""
        result = super().simple_test(feats, proposals, proposal_valid,
                                     batch, rescale)
        dets, labels = result['dets'], result['labels']
        b, d = dets.shape[:2]
        with record_function('mask_iou_branch'):
            rois, roi_batch = self._rois(dets, batch, rescale)
            mask_feats = to_nchw(self._extract(feats, rois, roi_batch,
                                               self.mask_roi_out))
            probs = result['mask_probs']
            iou = self.mask_iou_head(mask_feats,
                                     probs.reshape(b * d, *probs.shape[2:]))
            sel = iou.gather(1, labels.reshape(b * d).long().clamp(
                0, iou.shape[1] - 1)[:, None])[:, 0].reshape(b, d)
            result['segm_scores'] = dets[..., 4] * sel.clamp(0.0, 1.0)
        return result
