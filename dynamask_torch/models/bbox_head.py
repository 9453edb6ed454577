"""The conv/fc box heads, their training targets and loss, and test-time
decode (port of ``dynamask_tpu/models/bbox_head.py``: ``ConvFCBBoxHead``
and its ``Shared2FCBBoxHead`` / ``Shared4Conv1FCBBoxHead`` :26-90 and
the plain ``BBoxHead`` :92 of the C4 configs,
``bbox_targets_from_sample`` :107, ``bbox_head_loss`` :127-188 with its
L1, SmoothL1 and IoU-family regression, ``bbox_head_get_dets`` :190-226
with greedy or Soft-NMS). ``num_classes`` foreground classes, softmax
over ``num_classes + 1`` with background last. A class-agnostic head
(``reg_class_agnostic``, every Cascade R-CNN and HTC stage) regresses 4
deltas a RoI instead of 4 a class. With ``reg_decoded_bbox`` (the IoU
losses' configs) the targets are the GT boxes themselves and the loss
reads the deltas decoded on their RoIs."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox_transforms import bbox2delta, clip_boxes, delta2bbox
from ..core.samplers import SamplingResult
from ..ops.nms import multiclass_nms
from ..utils.registry import HEADS
from .layers import ConvModule
from .losses import (accuracy, balanced_l1_loss, bounded_iou_loss, iou_loss,
                     l1_loss, smooth_l1_loss, softmax_cross_entropy)

# the regression losses decoded boxes take: (loss function, its mode);
# mmdet's ``IoULoss`` is -log(IoU), as JAX reads it (``bbox_head.py:169``)
IOU_LOSSES = {'iou': (iou_loss, 'log_iou'), 'giou': (iou_loss, 'giou'),
              'bounded_iou': (bounded_iou_loss, None)}


@HEADS.register_module()
class ConvFCBBoxHead(nn.Module):
    """``num_shared_convs`` 3x3 convs (bias-free, each with a GroupNorm of
    ``gn_groups``, when ``norm='gn'``) with ReLU, then ``num_shared_fcs``
    fcs with ReLU, then the class scores and the deltas (JAX
    ``bbox_head.py:26-97``). The shared convs emit ``in_channels``, as
    JAX's do (its builder drops ``conv_out_channels``, ROADMAP.md queue 3,
    3w). ``with_reg=False`` builds no ``fc_reg``; ``with_avg_pool``
    averages each RoI's map over its bins before the fcs (JAX
    ``bbox_head.py:60-61``). mmdet's names: ``shared_convs.{i}.conv`` /
    ``.gn``, ``shared_fcs.{i}``, ``fc_cls``, ``fc_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 roi_feat_size: int = 7, fc_out_channels: int = 1024,
                 reg_class_agnostic: bool = False, num_shared_convs: int = 0,
                 num_shared_fcs: int = 2, norm: Optional[str] = None,
                 gn_groups: int = 32, with_reg: bool = True,
                 with_avg_pool: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.with_avg_pool = with_avg_pool
        self.reg_class_agnostic = reg_class_agnostic
        if norm not in (None, 'gn'):
            raise NotImplementedError(f'ConvFCBBoxHead norm {norm!r}')
        if num_shared_convs:
            self.shared_convs = nn.ModuleList(
                ConvModule(in_channels, in_channels, 3, padding=1,
                           gn_groups=gn_groups if norm else None)
                for _ in range(num_shared_convs))
        fcs, width = [], in_channels * (1 if with_avg_pool else
                                        roi_feat_size ** 2)
        for _ in range(num_shared_fcs):
            fcs.append(nn.Linear(width, fc_out_channels))
            width = fc_out_channels
        self.shared_fcs = nn.ModuleList(fcs)
        self.fc_cls = nn.Linear(width, num_classes + 1)
        if with_reg:
            self.fc_reg = nn.Linear(
                width, 4 if reg_class_agnostic else 4 * num_classes)

    def forward(self, x: torch.Tensor):
        """(N, P, P, C) NHWC RoI features -> (cls_logits (N, C+1),
        deltas (N, 4*C), or (N, 4) class-agnostic, or None without
        ``fc_reg`` (``with_reg=False``, Grid R-CNN's box head)). The first
        fc reads them in mmdet's CHW order."""
        x = x.permute(0, 3, 1, 2)
        for conv in getattr(self, 'shared_convs', ()):
            x = F.relu(conv(x))
        if self.with_avg_pool:
            x = x.mean((2, 3))
        x = x.reshape(x.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        reg = getattr(self, 'fc_reg', None)
        return self.fc_cls(x), None if reg is None else reg(x)


@HEADS.register_module()
class Shared2FCBBoxHead(ConvFCBBoxHead):
    """Two shared fcs (mmdet's standard head)."""

    def __init__(self, **kw):
        super().__init__(num_shared_convs=0, num_shared_fcs=2, **kw)


@HEADS.register_module()
class Shared4Conv1FCBBoxHead(ConvFCBBoxHead):
    """Four shared convs and one fc (the gn and gn+ws configs')."""

    def __init__(self, **kw):
        super().__init__(num_shared_convs=4, num_shared_fcs=1, **kw)


@HEADS.register_module()
class BBoxHead(ConvFCBBoxHead):
    """The plain head behind the C4 shared head: the RoI map averaged,
    then the class scores and the deltas, no fc between."""

    def __init__(self, **kw):
        super().__init__(num_shared_convs=0, num_shared_fcs=0,
                         with_avg_pool=True, **kw)


class BBoxTargets(NamedTuple):
    labels: torch.Tensor         # (N,) int64, num_classes = background
    label_weights: torch.Tensor  # (N,)
    bbox_targets: torch.Tensor   # (N, 4) encoded deltas (or GT boxes)
    bbox_weights: torch.Tensor   # (N,)


def bbox_targets_from_sample(sample: SamplingResult, num_classes: int,
                             target_means, target_stds,
                             reg_decoded_bbox: bool = False) -> BBoxTargets:
    """Box targets over the fixed sample slots (any leading shape): the
    encoded deltas, or with ``reg_decoded_bbox`` the GT boxes."""
    pos = sample.is_pos & sample.valid
    labels = torch.where(pos, sample.labels, num_classes)
    deltas = sample.target_boxes if reg_decoded_bbox else bbox2delta(
        sample.boxes, sample.target_boxes, target_means, target_stds)
    bbox_weights = pos.float()
    return BBoxTargets(labels, sample.valid.float(),
                       deltas * bbox_weights[..., None], bbox_weights)


def bbox_head_loss(cls_logits: torch.Tensor, bbox_deltas: torch.Tensor,
                   targets: BBoxTargets, num_classes: int,
                   loss_cls_weight: float = 1.0,
                   loss_bbox_weight: float = 1.0,
                   smooth_l1_beta: Optional[float] = None,
                   reg_class_agnostic: bool = False,
                   reg_loss_type: Optional[str] = None,
                   reg_decoded_bbox: bool = False,
                   rois: Optional[torch.Tensor] = None,
                   target_means=(0., 0., 0., 0.),
                   target_stds=(0.1, 0.1, 0.2, 0.2)):
    """CE averaged over the sampled RoIs; L1 (SmoothL1 of ``beta`` given
    ``smooth_l1_beta``) on each positive RoI's deltas (its class's, or
    the 4 of a class-agnostic head), averaged by the same count. With
    ``reg_decoded_bbox`` the deltas are first decoded on ``rois`` by
    ``target_means`` / ``target_stds``; ``reg_loss_type`` 'iou', 'giou'
    or 'bounded_iou' then takes the IoU loss of each positive box;
    'balanced_l1' the balanced L1 of beta ``smooth_l1_beta``."""
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
    if reg_decoded_bbox:
        pred = delta2bbox(rois, pred, target_means, target_stds)
    if reg_loss_type in IOU_LOSSES:
        fn, mode = IOU_LOSSES[reg_loss_type]
        w = targets.bbox_weights
        loss_bbox = (fn(pred, targets.bbox_targets, mode=mode, weight=w,
                        avg_factor=avg) if mode else
                     fn(pred, targets.bbox_targets, weight=w[:, None],
                        avg_factor=avg))
    elif reg_loss_type == 'balanced_l1':
        # Libra R-CNN: its beta in ``smooth_l1_beta``, alpha and gamma
        # fixed at 0.5 and 1.5 as in JAX
        loss_bbox = balanced_l1_loss(pred, targets.bbox_targets,
                                     smooth_l1_beta,
                                     weight=targets.bbox_weights[:, None],
                                     avg_factor=avg)
    elif smooth_l1_beta is None:
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
                       max_per_img: int = 100, rescale: bool = True,
                       nms_cfg: Optional[dict] = None):
    """Decode + multiclass NMS for one image -> (dets (max_per_img, 5),
    labels, valid). Class-agnostic (N, 4) deltas give one box a RoI,
    which every class's score shares. ``nms_cfg`` holds
    :func:`multiclass_nms`'s ``nms_type``, ``sigma`` and ``min_score``."""
    scores = F.softmax(cls_logits.float(), dim=-1)[:, :num_classes]
    boxes = delta2bbox(rois, bbox_deltas.float(), target_means, target_stds)
    boxes = clip_boxes(boxes.reshape(rois.shape[0], -1, 4), img_shape)
    if rescale:
        boxes = boxes / scale_factor.to(boxes.dtype)
    return multiclass_nms(boxes.reshape(rois.shape[0], -1), scores,
                          score_thr, iou_threshold, max_per_img,
                          valid=roi_valid, **(nms_cfg or {}))
