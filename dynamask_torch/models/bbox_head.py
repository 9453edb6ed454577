"""Shared-2FC box head, its training targets and loss, and test-time decode
(port of ``dynamask_tpu/models/bbox_head.py``: ``Shared2FCBBoxHead``,
``bbox_targets_from_sample`` :107, ``bbox_head_loss`` :127-188 with its
L1 and SmoothL1 regression, ``bbox_head_get_dets`` :190-226). ``num_classes``
foreground classes, softmax over ``num_classes + 1`` with background
last. A class-agnostic head (``reg_class_agnostic``, every Cascade R-CNN
and HTC stage) regresses 4 deltas a RoI instead of 4 a class."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox_transforms import bbox2delta, clip_boxes, delta2bbox
from ..core.samplers import SamplingResult
from ..ops.nms import multiclass_nms
from ..utils.registry import HEADS
from .losses import accuracy, l1_loss, smooth_l1_loss, softmax_cross_entropy


@HEADS.register_module()
class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_feat_size ** 2, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels,
                                4 if reg_class_agnostic else 4 * num_classes)

    def forward(self, x: torch.Tensor):
        """(N, P, P, C) NHWC RoI features -> (cls_logits (N, C+1),
        deltas (N, 4*C), or (N, 4) class-agnostic). The first fc reads them
        in mmdet's CHW order."""
        x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class BBoxTargets(NamedTuple):
    labels: torch.Tensor         # (N,) int64, num_classes = background
    label_weights: torch.Tensor  # (N,)
    bbox_targets: torch.Tensor   # (N, 4) encoded deltas
    bbox_weights: torch.Tensor   # (N,)


def bbox_targets_from_sample(sample: SamplingResult, num_classes: int,
                             target_means, target_stds) -> BBoxTargets:
    """Box targets over the fixed sample slots (any leading shape)."""
    pos = sample.is_pos & sample.valid
    labels = torch.where(pos, sample.labels, num_classes)
    deltas = bbox2delta(sample.boxes, sample.target_boxes, target_means,
                        target_stds)
    bbox_weights = pos.float()
    return BBoxTargets(labels, sample.valid.float(),
                       deltas * bbox_weights[..., None], bbox_weights)


def bbox_head_loss(cls_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                   targets: BBoxTargets, num_classes: int,
                   loss_cls_weight: float = 1.0,
                   loss_bbox_weight: float = 1.0,
                   smooth_l1_beta: Optional[float] = None,
                   reg_class_agnostic: bool = False):
    """CE averaged over the sampled RoIs; L1 (SmoothL1 of ``beta`` given
    ``smooth_l1_beta``) on each positive RoI's deltas (its class's, or
    the 4 of a class-agnostic head), averaged by the same count."""
    avg = targets.label_weights.sum()
    loss_cls = softmax_cross_entropy(cls_logits, targets.labels,
                                     targets.label_weights, avg)
    acc = accuracy(cls_logits, targets.labels, targets.label_weights)
    if reg_class_agnostic:
        pred = bbox_deltas
    else:
        n = bbox_deltas.shape[0]
        safe = targets.labels.clamp(0, num_classes - 1)
        pred = bbox_deltas.reshape(n, num_classes, 4)[torch.arange(
            n, device=safe.device), safe]
    if smooth_l1_beta is None:
        loss_bbox = l1_loss(pred, targets.bbox_targets,
                            targets.bbox_weights[:, None], avg)
    else:
        loss_bbox = smooth_l1_loss(pred, targets.bbox_targets,
                                   smooth_l1_beta,
                                   targets.bbox_weights[:, None], avg)
    return {'loss_cls': loss_cls_weight * loss_cls,
            'loss_bbox': loss_bbox_weight * loss_bbox, 'acc': acc}


def bbox_head_get_dets(rois: torch.Tensor, cls_logits: torch.Tensor,
                       bbox_deltas: torch.Tensor, roi_valid: torch.Tensor,
                       img_shape: torch.Tensor, scale_factor: torch.Tensor,
                       num_classes: int, target_means, target_stds,
                       score_thr: float = 0.05, iou_threshold: float = 0.5,
                       max_per_img: int = 100, rescale: bool = True):
    """Decode + multiclass NMS for one image -> (dets (max_per_img, 5),
    labels, valid). Class-agnostic (N, 4) deltas give one box a RoI,
    which every class's score shares."""
    scores = F.softmax(cls_logits.float(), dim=-1)[:, :num_classes]
    boxes = delta2bbox(rois, bbox_deltas.float(), target_means, target_stds)
    boxes = clip_boxes(boxes.reshape(rois.shape[0], -1, 4), img_shape)
    if rescale:
        boxes = boxes / scale_factor.to(boxes.dtype)
    return multiclass_nms(boxes.reshape(rois.shape[0], -1), scores,
                          score_thr, iou_threshold, max_per_img,
                          valid=roi_valid)
