"""The single-stage anchor detectors (port of ``dynamask_tpu/models/
single_stage.py``): ``RetinaHead`` and ``RetinaSepBNHead``, the dense
anchor loss (focal + L1, or GHM-C / GHM-R; the legacy v1 coder),
``anchor_head_get_dets`` and the ``RetinaNet`` detector.

Anchor targets are dense over the concatenated anchors of each image: no
sampling, every non-ignored anchor contributes to the classification loss,
normalised by the batch's positive count. The head's outputs go to fp32 at
the entry of the loss and of the decode (``core/fp16.py``).

Each stage is a ``record_function`` range: ``backbone``, ``fpn``, ``head``
and then ``loss`` in ``forward_train`` or ``get_dets`` in
``simple_test``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator, LegacyAnchorGenerator
from ..core.assigners import MaxIoUAssigner
from ..core.bbox_transforms import clip_boxes
from ..core.coders import DeltaXYWHBBoxCoder, LegacyDeltaXYWHBBoxCoder
from ..core.fp16 import at_least_f32
from ..ops.nms import multiclass_nms
from ..ops.point_sample import top_k
from ..utils.registry import DETECTORS, HEADS
from .detectors import _Detector
from .layers import ConvModule
from .losses import (balanced_l1_loss, focal_elementwise, ghm_c_loss,
                     ghm_r_loss)

# the focal-loss prior: a class bias of -log((1 - p) / p) at p = 0.01
PRIOR_BIAS = -4.59512


def head_conv(cin: int, cout: int, bias: bool = True,
              bias_init: Optional[float] = None, kernel: int = 3
              ) -> nn.Conv2d:
    """A 3x3 (or ``kernel`` x ``kernel``) conv of a dense head, initialised
    N(0, 0.01) as the JAX heads are (``normal_init(0.01)``), its bias 0 or
    ``bias_init``."""
    conv = nn.Conv2d(cin, cout, kernel, padding=kernel // 2, bias=bias)
    conv.init_rule = 0.01
    if bias_init is not None:
        conv.init_fill = {'bias': bias_init}
    return conv


class TowerConv(ConvModule):
    """One 3x3 (or ``kernel`` x ``kernel``) conv of a head's tower and its
    ReLU, mmcv's ``ConvModule`` names (``.conv``, then ``.gn`` or ``.bn``);
    the conv keeps its bias under a norm where ``bias`` says so, as ATSS's
    tower does in JAX."""

    def __init__(self, cin: int, cout: int, bias: bool = True,
                 gn_groups: Optional[int] = None, bn: bool = False,
                 kernel: int = 3):
        super().__init__(cin, cout, kernel, padding=kernel // 2,
                         gn_groups=gn_groups, bn=bn)
        self.conv = head_conv(cin, cout, bias=bias, kernel=kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(super().forward(x))


@HEADS.register_module()
class RetinaHead(nn.Module):
    """Cls and reg towers of ``stacked_convs`` 3x3 convs, shared across the
    levels, then ``retina_cls`` (the prior bias) and ``retina_reg``."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9):
        super().__init__()
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1]) for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1]) for i in range(stacked_convs)])
        self.retina_cls = head_conv(chans[-1], num_anchors * num_classes,
                                    bias_init=PRIOR_BIAS)
        self.retina_reg = head_conv(chans[-1], num_anchors * 4)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW levels -> per level (B, A*C, H, W) scores and (B, A*4, H, W)
        deltas."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds


@HEADS.register_module()
class RetinaSepBNHead(RetinaHead):
    """``RetinaHead`` whose tower convs are shared across the ``num_ins``
    levels but each level has its own BatchNorms (mmdet's
    ``RetinaSepBNHead``: ``cls_convs.{level}.{i}`` with one ``.conv``
    shared by every level); bias-free tower convs, as JAX's."""

    def __init__(self, num_classes: int = 80, num_ins: int = 5,
                 in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, num_anchors: int = 9):
        super().__init__(num_classes, in_channels, feat_channels,
                         stacked_convs, num_anchors)
        chans = [in_channels] + [feat_channels] * stacked_convs
        for name in ('cls_convs', 'reg_convs'):
            levels = nn.ModuleList(
                [nn.ModuleList([TowerConv(chans[i], chans[i + 1], bias=False,
                                          bn=True)
                                for i in range(stacked_convs)])
                 for _ in range(num_ins)])
            for lvl in levels[1:]:
                for i, conv in enumerate(lvl):
                    conv.conv = levels[0][i].conv
            setattr(self, name, levels)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, bbox_preds = [], []
        for lvl, x in enumerate(feats):
            c, r = x, x
            for conv in self.cls_convs[lvl]:
                c = conv(c)
            for conv in self.reg_convs[lvl]:
                r = conv(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds


def flatten_levels(maps: Sequence[torch.Tensor], channels: int
                   ) -> torch.Tensor:
    """Per-level (B, A*channels, H, W) maps -> (B, sum H*W*A, channels) in
    fp32 (float64 stays), location-major and anchor-minor like the
    anchors."""
    b = maps[0].shape[0]
    return at_least_f32(torch.cat([m.permute(0, 2, 3, 1).reshape(
        b, -1, channels) for m in maps], 1))


def one_hot_fg(labels: torch.Tensor, pos: torch.Tensor,
               num_classes: int) -> torch.Tensor:
    """The (..., num_classes) 0/1 targets: the label's column on a
    positive, none elsewhere."""
    idx = torch.where(pos, labels, num_classes)
    return F.one_hot(idx, num_classes + 1)[..., :num_classes].float()


def anchor_head_loss(cls_scores: List[torch.Tensor],
                     bbox_preds: List[torch.Tensor], anchors: torch.Tensor,
                     anchor_valid: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     num_classes: int, assigner: MaxIoUAssigner, coder,
                     focal_gamma: float = 2.0, focal_alpha: float = 0.25,
                     loss_cls_weight: float = 1.0,
                     loss_bbox_weight: float = 1.0,
                     cls_loss_type: str = 'focal', reg_loss_type: str = 'l1',
                     ghm_c_bins: int = 30, ghm_r_bins: int = 10,
                     ghm_mu: float = 0.02) -> Dict[str, torch.Tensor]:
    """The dense anchor loss (JAX ``anchor_head_loss``): each image's
    anchors (A, 4) with their validity (B, A) assigned to its GTs; the
    focal (or GHM-C) loss over the positive and negative anchors, the L1
    (GHM-R, or Libra's balanced L1) loss of the positives' ``coder``
    deltas."""
    flat_cls = flatten_levels(cls_scores, num_classes)
    flat_reg = flatten_levels(bbox_preds, 4)
    pos, include, labels, targets = [], [], [], []
    for i in range(flat_cls.shape[0]):
        a = assigner(anchors, anchor_valid[i], gt_boxes[i], gt_valid[i],
                     gt_labels[i])
        p = a.gt_inds > 0
        pos.append(p)
        include.append(p | ((a.gt_inds == 0) & anchor_valid[i].bool()))
        labels.append(a.labels.clamp(min=0))
        idx = (a.gt_inds - 1).clamp(0, gt_boxes.shape[1] - 1)
        targets.append(coder.encode(anchors, gt_boxes[i][idx]))
    pos, include = torch.stack(pos), torch.stack(include)
    onehot = one_hot_fg(torch.stack(labels), pos, num_classes)
    targets = torch.stack(targets)
    avg = pos.sum().clamp(min=1).float()
    if cls_loss_type == 'ghmc':
        loss_cls = ghm_c_loss(
            flat_cls.reshape(-1, num_classes), onehot.reshape(-1, num_classes),
            include[..., None].expand_as(onehot).reshape(-1, num_classes),
            ghm_c_bins)
    else:
        loss_cls = (focal_elementwise(flat_cls, onehot, focal_gamma,
                                      focal_alpha) *
                    include[..., None]).sum() / avg
    if reg_loss_type == 'ghmr':
        loss_bbox = ghm_r_loss(
            flat_reg.reshape(-1, 4), targets.reshape(-1, 4),
            pos[..., None].expand_as(targets).reshape(-1, 4).float(),
            ghm_mu, ghm_r_bins)
    elif reg_loss_type == 'balanced_l1':
        # Libra RetinaNet: JAX fixes beta 0.11, alpha 0.5, gamma 1.5
        loss_bbox = balanced_l1_loss(
            flat_reg.reshape(-1, 4), targets.reshape(-1, 4), beta=0.11,
            weight=pos[..., None].expand_as(targets).reshape(-1, 4).float(),
            avg_factor=avg)
    else:
        loss_bbox = ((flat_reg - targets).abs() * pos[..., None]).sum() / avg
    return {'loss_cls': loss_cls_weight * loss_cls,
            'loss_bbox': loss_bbox_weight * loss_bbox}


def dense_nms(boxes: torch.Tensor, scores: torch.Tensor, batch: Dict,
              score_thr: float, iou_thr: float, max_per_img: int,
              rescale: bool = True, clip_inset: float = 0.0
              ) -> Dict[str, torch.Tensor]:
    """Per image: the (N, 4) boxes clipped to ``img_shape`` less
    ``clip_inset`` (FoveaBox clips to ``w - 1``, ``h - 1``), divided by
    ``scale_factor`` with ``rescale``, then ``multiclass_nms`` over the
    (N, C) scores -> dets (B, max_per_img, 5), labels, det_valid."""
    boxes = clip_boxes(boxes, batch['img_shape'][:, None, :].to(boxes.dtype)
                       - clip_inset)
    dets, labels, valid = [], [], []
    for i in range(boxes.shape[0]):
        b = boxes[i]
        if rescale:
            b = b / batch['scale_factor'][i].to(b.dtype)
        d, lab, v = multiclass_nms(b, scores[i], score_thr, iou_thr,
                                   max_per_img)
        dets.append(d)
        labels.append(lab)
        valid.append(v)
    return {'dets': torch.stack(dets), 'labels': torch.stack(labels),
            'det_valid': torch.stack(valid)}


def dense_get_dets(cls_scores, bbox_preds, priors, batch: Dict,
                   num_classes: int, decode, cent_preds=None,
                   nms_pre: int = 1000, score_thr: float = 0.05,
                   iou_thr: float = 0.5, max_per_img: int = 100,
                   rescale: bool = True, reg_channels: int = 4,
                   clip_inset: float = 0.0) -> Dict[str, torch.Tensor]:
    """The dense heads' test path (JAX ``anchor_head_get_dets`` and the
    dense detectors' ``simple_test``): per level the class sigmoids (times
    the centerness sigmoid, given ``cent_preds``), the ``nms_pre``
    priors (anchors or points) of highest max-class score, the lower
    index first among equal scores as ``jax.lax.top_k`` takes them
    (``ops.point_sample.top_k``), their ``reg_channels`` regression
    outputs decoded by ``decode(priors, preds)``; then :func:`dense_nms`."""
    lvl_boxes, lvl_scores = [], []
    for i, (cs, bp, pr) in enumerate(zip(cls_scores, bbox_preds, priors)):
        scores = torch.sigmoid(flatten_levels([cs], num_classes))
        if cent_preds is not None:
            scores = scores * torch.sigmoid(flatten_levels([cent_preds[i]],
                                                           1))
        k = min(nms_pre, scores.shape[1])
        idx = top_k(scores.max(-1).values, k)[1]
        lvl_scores.append(scores.gather(
            1, idx[..., None].expand(-1, -1, num_classes)))
        preds = flatten_levels([bp], reg_channels).gather(
            1, idx[..., None].expand(-1, -1, reg_channels))
        lvl_boxes.append(decode(pr[idx], preds))
    return dense_nms(torch.cat(lvl_boxes, 1), torch.cat(lvl_scores, 1),
                     batch, score_thr, iou_thr, max_per_img, rescale,
                     clip_inset)


def anchor_head_get_dets(cls_scores, bbox_preds, mlvl_anchors,
                         batch: Dict, num_classes: int, coder,
                         **test_cfg) -> Dict[str, torch.Tensor]:
    """JAX ``anchor_head_get_dets``: :func:`dense_get_dets` over the
    anchors, decoded by ``coder``."""
    return dense_get_dets(cls_scores, bbox_preds, mlvl_anchors, batch,
                          num_classes, coder.decode, **test_cfg)


class DenseDetector(_Detector):
    """A backbone, its neck and a dense head (``bbox_head``) over
    ``num_classes``; ``test_cfg`` holds the test path's options."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, num_classes: int, nms_pre: int,
                 score_thr: float, nms_iou_thr: float, max_per_img: int):
        super().__init__(backbone, neck)
        self.bbox_head = bbox_head
        self.num_classes = num_classes
        self.test_cfg = dict(nms_pre=nms_pre, score_thr=score_thr,
                             iou_thr=nms_iou_thr, max_per_img=max_per_img)

    def head(self, batch: Dict[str, torch.Tensor]):
        """The levels and the head's outputs of ``batch``."""
        feats = self.extract_feat(self.images(batch))
        with record_function('head'):
            return feats, self.bbox_head(feats)


@DETECTORS.register_module()
class SingleStageDetector(DenseDetector):
    """Backbone, neck and a dense anchor head (JAX ``SingleStageDetector``
    / ``RetinaNet``): ``forward_train`` is the dense anchor loss,
    ``simple_test`` returns dets (B, max_per_img, 5), labels and
    det_valid. ``legacy`` takes mmdet v1.x's anchors and coder."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, num_classes: int = 80,
                 anchor_octave_base_scale: float = 4.0,
                 anchor_scales_per_octave: int = 3,
                 anchor_ratios=(0.5, 1.0, 2.0),
                 anchor_strides=(8, 16, 32, 64, 128),
                 target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.),
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                 min_pos_iou: float = 0.0, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25, cls_loss_type: str = 'focal',
                 reg_loss_type: str = 'l1', ghm_c_bins: int = 30,
                 ghm_r_bins: int = 10, ghm_mu: float = 0.02,
                 loss_cls_weight: float = 1.0, loss_bbox_weight: float = 1.0,
                 legacy: bool = False, nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        gen = LegacyAnchorGenerator if legacy else AnchorGenerator
        self.anchor_generator = gen(
            anchor_strides, anchor_ratios,
            octave_base_scale=anchor_octave_base_scale,
            scales_per_octave=anchor_scales_per_octave,
            center_offset=0.5 if legacy else 0.0)
        self.bbox_coder = (LegacyDeltaXYWHBBoxCoder if legacy else
                           DeltaXYWHBBoxCoder)(target_means, target_stds)
        self.assigner = MaxIoUAssigner(pos_iou_thr, neg_iou_thr, min_pos_iou,
                                       match_low_quality=True)
        self.loss_cfg = dict(
            focal_gamma=focal_gamma, focal_alpha=focal_alpha,
            loss_cls_weight=loss_cls_weight,
            loss_bbox_weight=loss_bbox_weight, cls_loss_type=cls_loss_type,
            reg_loss_type=reg_loss_type, ghm_c_bins=ghm_c_bins,
            ghm_r_bins=ghm_r_bins, ghm_mu=ghm_mu)

    def anchors(self, feats):
        """(per-level anchors, their feature-map sizes)."""
        sizes = [tuple(f.shape[-2:]) for f in feats]
        return self.anchor_generator.grid_anchors(sizes, feats[0].device), \
            sizes

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of one padded batch (``image``, ``img_shape``,
        ``gt_boxes``, ``gt_labels``, ``gt_valid``); nothing is drawn at
        random, so ``noise`` and ``generator`` are not read. An anchor
        over the canvas padding (from ``img_shape``, as JAX; ROADMAP.md
        queue 3, 3ad) takes no part."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            mlvl, sizes = self.anchors(feats)
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            return anchor_head_loss(
                cls_scores, bbox_preds, torch.cat(mlvl), valid,
                batch['gt_boxes'], batch['gt_labels'], batch['gt_valid'],
                self.num_classes, self.assigner, self.bbox_coder,
                **self.loss_cfg)

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """``batch['image']`` (B, H, W, 3) NHWC, ``img_shape`` (B, 2),
        ``scale_factor`` (B, 4) -> dets (B, max_per_img, 5), labels,
        det_valid."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('get_dets'):
            mlvl, _ = self.anchors(feats)
            return anchor_head_get_dets(
                cls_scores, bbox_preds, mlvl, batch, self.num_classes,
                self.bbox_coder, rescale=rescale, **self.test_cfg)


@DETECTORS.register_module()
class RetinaNet(SingleStageDetector):
    """mmdet's ``RetinaNet``: the single-stage detector."""
