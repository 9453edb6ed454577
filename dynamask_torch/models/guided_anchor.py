"""Guided anchoring (port of ``dynamask_tpu/models/guided_anchor.py``):
``FeatureAdaption`` (:46-66), ``GARetinaHead`` (:69-127), the dense
location targets ``ga_loc_targets_level`` (:130-190), ``GARetinaNet``
(:192-436), ``GARPNHead`` (:438-475) and the GA-RPN detectors
``GAFasterRCNN`` / ``GARPN`` (:477-711).

Three box families (mmdet ``guided_anchor_head.py``): 9 "approx" anchors a
location to assign the shape targets, one "square" anchor a location that
the shape branch refines, and the guided anchors (the squares with the
predicted width and height, centres fixed) that the classification and
regression branch trains on. As in JAX:

- ``FeatureAdaption``'s 3x3 deformable conv takes the windowed form
  (``window=3``, 4 deform groups; mmcv's is unbounded, 3au): K1
  forward, K1 + K3 backward
  (``ops.deform_conv.deform_conv2d_nhwc``), on every FPN level of a
  batch. Its offsets come from a 1x1 conv of the detached shape
  prediction, whose weight still trains through K3's offset gradient;
- ``MaskedConv2d`` is a dense conv; the location filter zeroes the
  filtered positions' scores (GA-RetinaNet) or drives their logits to
  -1e4 (GA-RPN), which gives the reference's outputs;
- the location targets are the dense center > ignore > negative rule;
- the shape targets take, per square, the largest IoU of its 9 approx
  anchors with each GT, assign by max IoU and sample at random
  (``noise['ga_pos']`` / ``noise['ga_neg']``, (B, squares) draws, where
  the JAX package draws from its key);
- the JAX package's faults stand (ROADMAP.md queue 3): GA-RPN decodes the
  shape deltas with unit stds whatever ``anchor_coder`` says (3aq); one
  set of valid flags, from image 0's ``img_shape``, serves the batch
  (3ar); the guided anchors' ``wh_ratio_clip`` is the coder's 16/1000,
  where mmdet decodes them with 1e-6 (3as).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..core.assigners import MaxIoUAssigner
from ..core.bbox_transforms import bbox2delta, bbox_overlaps, delta2bbox
from ..core.samplers import RandomSampler, _rank
from ..ops.deform_conv import deform_conv2d_nhwc
from ..utils.registry import DETECTORS, HEADS
from .detectors import _Detector
from .layers import to_nchw, to_nhwc
from .losses import bounded_iou_loss, focal_elementwise, smooth_l1_elementwise
from .rpn_head import rpn_get_proposals, rpn_loss
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv, dense_nms,
                           flatten_levels, head_conv, one_hot_fg)

UNIT_STDS = (1., 1., 1., 1.)
ZERO_MEANS = (0., 0., 0., 0.)


class _DeformWeight(nn.Module):
    """The bias-free (C_out, C_in, 3, 3) kernel of mmcv's ``DeformConv2d``
    (``conv_adaption.weight``), N(0, 0.01) as JAX draws it."""

    init_rule = 0.01

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 3,
                                               3))


class FeatureAdaption(nn.Module):
    """A 1x1 ``conv_offset`` (bias-free, N(0, 0.1)) over the detached
    2-channel shape prediction, feeding a 3x3 windowed deformable conv of
    ``deform_groups`` groups, then a ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 deform_groups: int = 4, window: int = 3):
        super().__init__()
        self.deform_groups, self.window = deform_groups, window
        self.conv_offset = nn.Conv2d(2, deform_groups * 18, 1, bias=False)
        self.conv_offset.init_rule = 0.1
        self.conv_adaption = _DeformWeight(in_channels, out_channels)

    def forward(self, x: torch.Tensor, shape_pred: torch.Tensor
                ) -> torch.Tensor:
        off = to_nhwc(self.conv_offset(shape_pred.detach()))
        out = deform_conv2d_nhwc(to_nhwc(x), off, self.conv_adaption.weight,
                                 3, 1, 1, self.deform_groups, self.window)
        return F.relu(to_nchw(out))


def _conv1x1(cin: int, cout: int, bias_init: Optional[float] = None
             ) -> nn.Conv2d:
    """A 1x1 conv of a GA head: N(0, 0.01), its bias 0 or ``bias_init``."""
    conv = nn.Conv2d(cin, cout, 1)
    conv.init_rule = 0.01
    if bias_init is not None:
        conv.init_fill = {'bias': bias_init}
    return conv


@HEADS.register_module()
class GARetinaHead(nn.Module):
    """Cls and reg towers, the 1x1 ``conv_loc`` (the prior bias) on the cls
    tower and ``conv_shape`` on the reg tower, a ``FeatureAdaption`` each,
    then the 3x3 ``retina_cls`` / ``retina_reg`` (dense for mmdet's
    ``MaskedConv2d``). Returns per level the class logits (B, C, H, W),
    the deltas (B, 4, H, W), the shape deltas (B, 2, H, W) and the location
    logits (B, 1, H, W)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 deform_groups: int = 4):
        super().__init__()
        self.num_classes = num_classes
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1]) for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1]) for i in range(stacked_convs)])
        c = chans[-1]
        self.conv_loc = _conv1x1(c, 1, PRIOR_BIAS)
        self.conv_shape = _conv1x1(c, 2)
        self.feature_adaption_cls = FeatureAdaption(c, c, deform_groups)
        self.feature_adaption_reg = FeatureAdaption(c, c, deform_groups)
        self.retina_cls = head_conv(c, num_classes, bias_init=PRIOR_BIAS)
        self.retina_reg = head_conv(c, 4)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, shape_out, loc_out = [], [], [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            loc_pred = self.conv_loc(c)
            shape_pred = self.conv_shape(r)
            c = self.feature_adaption_cls(c, shape_pred)
            r = self.feature_adaption_reg(r, shape_pred)
            cls_out.append(self.retina_cls(c))
            reg_out.append(self.retina_reg(r))
            shape_out.append(shape_pred)
            loc_out.append(loc_pred)
        return cls_out, reg_out, shape_out, loc_out


@HEADS.register_module()
class GARPNHead(nn.Module):
    """The shared 3x3 ``rpn_conv`` and its ReLU, then the 1x1 ``conv_loc``
    and ``conv_shape``, one ``FeatureAdaption`` and the 1x1 binary
    ``conv_cls`` and 4-channel ``conv_reg`` on its output (every weight
    N(0, 0.01) under ``rpn_head.``, the offsets' N(0, 0.1))."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 deform_groups: int = 4):
        super().__init__()
        f = feat_channels
        self.rpn_conv = nn.Conv2d(in_channels, f, 3, padding=1)
        self.conv_loc = _conv1x1(f, 1, PRIOR_BIAS)
        self.conv_shape = _conv1x1(f, 2)
        self.feature_adaption = FeatureAdaption(f, f, deform_groups)
        self.conv_cls = _conv1x1(f, 1)
        self.conv_reg = _conv1x1(f, 4)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_out, reg_out, shape_out, loc_out = [], [], [], []
        for x in feats:
            x = F.relu(self.rpn_conv(x))
            shape = self.conv_shape(x)
            xa = self.feature_adaption(x, shape)
            cls_out.append(self.conv_cls(xa))
            reg_out.append(self.conv_reg(xa))
            shape_out.append(shape)
            loc_out.append(self.conv_loc(x))
        return cls_out, reg_out, shape_out, loc_out


def calc_region(boxes: torch.Tensor, ratio: float):
    """The proportional sub-region of each box, rounded to cells (half to
    even, as ``jnp.round``)."""
    x1 = torch.round((1 - ratio) * boxes[:, 0] + ratio * boxes[:, 2])
    y1 = torch.round((1 - ratio) * boxes[:, 1] + ratio * boxes[:, 3])
    x2 = torch.round(ratio * boxes[:, 0] + (1 - ratio) * boxes[:, 2])
    y2 = torch.round(ratio * boxes[:, 1] + (1 - ratio) * boxes[:, 3])
    return x1, y1, x2, y2


def ga_loc_targets_level(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                         lvl: int, num_lvls: int,
                         featmap_size: Tuple[int, int],
                         strides: torch.Tensor, min_anchor_size: float,
                         center_ratio: float, ignore_ratio: float):
    """One image's dense location targets on level ``lvl``: (target,
    weight), each (H*W,): 1 / 1 in the center regions of the GTs this level
    holds, weight 0 in their ignore regions and in those of the adjacent
    levels' GTs (taken in this level's cells, as JAX does), 0.1
    elsewhere."""
    h, w = featmap_size
    dev = gt_boxes.device
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = torch.sqrt(((gt_boxes[:, 2] - gt_boxes[:, 0]) *
                        (gt_boxes[:, 3] - gt_boxes[:, 1])).clamp(min=1e-6))
    target_lvls = torch.floor(
        torch.log2(scale) - torch.log2(torch.tensor(
            float(min_anchor_size), device=dev)) + 0.5).clamp(0, num_lvls - 1)
    iy, ix = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing='ij')
    ix = ix.reshape(-1)[:, None]
    iy = iy.reshape(-1)[:, None]
    gt_valid = gt_valid.bool()

    def member(region, lsel):
        x1, y1, x2, y2 = region
        x1, x2 = x1.clamp(0, w - 1), x2.clamp(0, w - 1)
        y1, y2 = y1.clamp(0, h - 1), y2.clamp(0, h - 1)
        m = ((ix >= x1[None]) & (ix <= x2[None]) & (iy >= y1[None]) &
             (iy <= y2[None]) & (gt_valid & lsel)[None, :])
        return m.any(-1)

    gl = gt_boxes / strides[lvl]
    at_lvl = target_lvls == lvl
    in_center = member(calc_region(gl, r1), at_lvl)
    in_ignore = member(calc_region(gl, r2), at_lvl)
    if lvl > 0:
        in_ignore = in_ignore | member(calc_region(gl, r2),
                                       target_lvls == lvl - 1)
    if lvl < num_lvls - 1:
        in_ignore = in_ignore | member(calc_region(gl, r2),
                                       target_lvls == lvl + 1)
    target = in_center.float()
    weight = torch.where(in_center, 1.0, torch.where(in_ignore, 0.0, 0.1))
    return target, weight


class GuidedAnchors:
    """What the GA detectors share: the approx and square generators, the
    location and shape losses and the guided anchors. ``target_stds`` are
    those the guided anchors are decoded with (``shape_stds``) and, on
    GA-RetinaNet, those of its regression too."""

    def _ga_init(self, octave_base_scale: float, scales_per_octave: int,
                 anchor_ratios, anchor_strides, shape_stds,
                 ga_pos_iou_thr: float, ga_neg_iou_thr: float,
                 ga_min_pos_iou: float, ga_sample_num: int,
                 ga_pos_fraction: float, center_ratio: float,
                 ignore_ratio: float, shape_beta: float,
                 loc_filter_thr: float, focal_gamma: float = 2.0,
                 focal_alpha: float = 0.25) -> None:
        self.anchor_strides = tuple(anchor_strides)
        self.approx_generator = AnchorGenerator(
            anchor_strides, anchor_ratios,
            octave_base_scale=octave_base_scale,
            scales_per_octave=scales_per_octave)
        self.square_generator = AnchorGenerator(
            anchor_strides, (1.0,), scales=(octave_base_scale,))
        self.min_anchor_size = octave_base_scale * anchor_strides[0]
        self.shape_stds = tuple(shape_stds)
        self.ga_assigner = MaxIoUAssigner(ga_pos_iou_thr, ga_neg_iou_thr,
                                          ga_min_pos_iou,
                                          match_low_quality=True)
        self.ga_sample_num = ga_sample_num
        self.ga_pos_fraction = ga_pos_fraction
        self.center_ratio, self.ignore_ratio = center_ratio, ignore_ratio
        self.shape_beta = shape_beta
        self.loc_filter_thr = loc_filter_thr
        self.focal_gamma, self.focal_alpha = focal_gamma, focal_alpha

    def squares(self, sizes, device) -> List[torch.Tensor]:
        return self.square_generator.grid_anchors(sizes, device)

    def guided_anchors(self, squares: torch.Tensor,
                       shape_preds: Sequence[torch.Tensor]) -> torch.Tensor:
        """(A, 4) squares with the detached shape deltas of each image ->
        (B, A, 4): the centre kept, the width and height scaled by
        ``exp(delta * std)``."""
        flat = flatten_levels(shape_preds, 2).detach()
        deltas = torch.cat([torch.zeros_like(flat), flat], -1)
        return delta2bbox(squares, deltas, ZERO_MEANS, self.shape_stds)

    def square_valid(self, sizes, img_shape: torch.Tensor) -> torch.Tensor:
        """The squares' valid flags (A,): image 0's, for every image (3ar,
        as JAX's ``valid_flags(sizes, img_shape[0])``)."""
        return torch.cat(self.square_generator.valid_flags(
            sizes, img_shape[:1]), 1)[0]

    def loc_loss(self, loc_preds, sizes, batch) -> torch.Tensor:
        """The focal loss of the location logits against the dense targets,
        weighted, over ``B * cells / 200``."""
        b = loc_preds[0].shape[0]
        dev = loc_preds[0].device
        strides = torch.tensor(self.anchor_strides, dtype=torch.float32,
                               device=dev)
        flat = flatten_levels(loc_preds, 1)[..., 0]
        targets, weights = [], []
        for i in range(b):
            ts, ws = zip(*[ga_loc_targets_level(
                batch['gt_boxes'][i].float(), batch['gt_valid'][i], lvl,
                len(sizes), size, strides, self.min_anchor_size,
                self.center_ratio, self.ignore_ratio)
                for lvl, size in enumerate(sizes)])
            targets.append(torch.cat(ts))
            weights.append(torch.cat(ws))
        loc_t, loc_w = torch.stack(targets), torch.stack(weights)
        cells = sum(h * w for h, w in sizes)
        return (focal_elementwise(flat, loc_t, self.focal_gamma,
                                  self.focal_alpha) * loc_w).sum() / (
            b * cells / 200.0)

    def shape_loss(self, shape_preds, sizes, squares: torch.Tensor,
                   square_valid: torch.Tensor, batch, noise: dict,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
        """The bounded IoU loss of the decoded squares against their GTs,
        over the sampled positives, divided by the batch's sampled count
        (at least 1 positive and 1 negative an image)."""
        dev = squares.device
        approxs = torch.cat(self.approx_generator.grid_anchors(sizes, dev))
        na = squares.shape[0]
        approxs = approxs.reshape(-1, 4)
        flat = flatten_levels(shape_preds, 2)
        pred = delta2bbox(squares, torch.cat([torch.zeros_like(flat), flat],
                                             -1), ZERO_MEANS, self.shape_stds)
        cap = int(self.ga_sample_num * self.ga_pos_fraction)
        total, count = 0.0, 0
        for i in range(flat.shape[0]):
            gts = batch['gt_boxes'][i].float()
            gvalid = batch['gt_valid'][i].bool()
            ov = bbox_overlaps(gts, approxs).reshape(gts.shape[0], na, -1)
            ov = torch.where(gvalid[:, None] & square_valid[None, :],
                             ov.max(-1).values, -1.0)
            assign = self.ga_assigner.assign_wrt_overlaps(ov, gvalid,
                                                          square_valid)
            pos = assign.gt_inds > 0
            neg = (assign.gt_inds == 0) & square_valid

            def draws(key):
                given = noise.get(key)
                if given is not None:
                    return given[i].to(dev, torch.float32)
                return torch.rand(na, generator=generator, device=dev)

            pr = torch.where(pos, draws('ga_pos'), -1.0)
            pos_keep = pos & (_rank(-pr) < cap)
            n_pos = pos_keep.sum()
            nr = torch.where(neg, draws('ga_neg'), -1.0)
            n_neg = (neg & (_rank(-nr) < self.ga_sample_num - n_pos)).sum()
            gt_idx = (assign.gt_inds - 1).clamp(0, gts.shape[0] - 1)
            total = total + bounded_iou_loss(
                pred[i], gts[gt_idx], beta=self.shape_beta,
                weight=pos_keep.float()[:, None], avg_factor=1.0)
            count = count + n_pos.clamp(min=1) + n_neg.clamp(min=1)
        return total / torch.as_tensor(count, dtype=torch.float32).clamp(
            min=1.0)


@DETECTORS.register_module()
class GARetinaNet(GuidedAnchors, DenseDetector):
    """RetinaNet over a ``GARetinaHead`` (mmdet's ``RetinaNet`` with the
    GA head): ``forward_train`` gives ``loss_cls`` / ``loss_bbox`` (focal
    and SmoothL1 over the guided anchors' max-IoU assignment, over the
    positives), ``loss_shape`` and ``loss_loc``; ``simple_test`` the dets
    of the guided anchors whose location passes the filter."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: nn.Module, num_classes: int = 80,
                 octave_base_scale: float = 4.0, scales_per_octave: int = 3,
                 anchor_ratios=(0.5, 1.0, 2.0),
                 anchor_strides=(8, 16, 32, 64, 128),
                 target_stds=UNIT_STDS, ga_pos_iou_thr: float = 0.5,
                 ga_neg_iou_thr: float = 0.4, ga_min_pos_iou: float = 0.4,
                 ga_sample_num: int = 256, ga_pos_fraction: float = 0.5,
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.5,
                 min_pos_iou: float = 0.0, center_ratio: float = 0.2,
                 ignore_ratio: float = 0.5, smoothl1_beta: float = 0.04,
                 shape_beta: float = 0.2, loc_filter_thr: float = 0.01,
                 nms_pre: int = 1000, score_thr: float = 0.05,
                 nms_iou_thr: float = 0.5, max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self._ga_init(octave_base_scale, scales_per_octave, anchor_ratios,
                      anchor_strides, target_stds, ga_pos_iou_thr,
                      ga_neg_iou_thr, ga_min_pos_iou, ga_sample_num,
                      ga_pos_fraction, center_ratio, ignore_ratio,
                      shape_beta, loc_filter_thr)
        self.assigner = MaxIoUAssigner(pos_iou_thr, neg_iou_thr, min_pos_iou,
                                       match_low_quality=True)
        self.smoothl1_beta = smoothl1_beta

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The four losses of one padded batch; the shape sampler's draws
        are ``noise``'s 'ga_pos' / 'ga_neg' (B, squares), else from
        ``generator``."""
        noise = noise or {}
        feats, (cls_scores, bbox_preds, shape_preds, loc_preds) = \
            self.head(batch)
        with record_function('loss'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            squares = torch.cat(self.squares(sizes, feats[0].device))
            valid = self.square_valid(sizes, batch['img_shape'])
            losses = {'loss_loc': self.loc_loss(loc_preds, sizes, batch),
                      'loss_shape': self.shape_loss(
                          shape_preds, sizes, squares, valid, batch, noise,
                          generator)}
            guided = self.guided_anchors(squares, shape_preds)
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            flat_reg = flatten_levels(bbox_preds, 4)
            cls_l = reg_l = n_pos = 0.0
            for i in range(flat_cls.shape[0]):
                a = self.assigner(guided[i], valid, batch['gt_boxes'][i],
                                  batch['gt_valid'][i], batch['gt_labels'][i])
                pos = a.gt_inds > 0
                include = pos | ((a.gt_inds == 0) & valid)
                onehot = one_hot_fg(a.labels.clamp(min=0), pos,
                                    self.num_classes)
                cls_l = cls_l + (focal_elementwise(
                    flat_cls[i], onehot, self.focal_gamma, self.focal_alpha) *
                    include[:, None]).sum()
                gts = batch['gt_boxes'][i].float()
                idx = (a.gt_inds - 1).clamp(0, gts.shape[0] - 1)
                tgt = bbox2delta(guided[i], gts[idx], ZERO_MEANS,
                                 self.shape_stds)
                reg_l = reg_l + (smooth_l1_elementwise(
                    flat_reg[i], tgt, self.smoothl1_beta) *
                    pos[:, None]).sum()
                n_pos = n_pos + pos.sum()
            avg = torch.as_tensor(n_pos, dtype=torch.float32).clamp(min=1.0)
            losses.update(loss_cls=cls_l / avg, loss_bbox=reg_l / avg)
        return losses

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        feats, (cls_scores, bbox_preds, shape_preds, loc_preds) = \
            self.head(batch)
        with record_function('get_dets'):
            sizes = [tuple(f.shape[-2:]) for f in feats]
            lvl_boxes, lvl_scores = [], []
            for cs, bp, sp, lp, sq in zip(cls_scores, bbox_preds, shape_preds,
                                          loc_preds, self.squares(
                                              sizes, feats[0].device)):
                keep = torch.sigmoid(flatten_levels([lp], 1)) >= \
                    self.loc_filter_thr
                scores = torch.sigmoid(flatten_levels(
                    [cs], self.num_classes)) * keep
                anchors = self.guided_anchors(sq, [sp])
                k = min(self.test_cfg['nms_pre'], scores.shape[1])
                idx = torch.topk(scores.max(-1).values, k, dim=1).indices
                lvl_scores.append(scores.gather(
                    1, idx[..., None].expand(-1, -1, self.num_classes)))
                pick = idx[..., None].expand(-1, -1, 4)
                lvl_boxes.append(delta2bbox(
                    anchors.gather(1, pick),
                    flatten_levels([bp], 4).gather(1, pick), ZERO_MEANS,
                    self.shape_stds))
            cfg = self.test_cfg
            return dense_nms(torch.cat(lvl_boxes, 1), torch.cat(lvl_scores, 1),
                             batch, cfg['score_thr'], cfg['iou_thr'],
                             cfg['max_per_img'], rescale)


def _split_levels(guided: torch.Tensor, sizes) -> List[torch.Tensor]:
    out, start = [], 0
    for h, w in sizes:
        out.append(guided[:, start:start + h * w])
        start += h * w
    return out


@DETECTORS.register_module()
class GARPN(GuidedAnchors, _Detector):
    """The guided-anchor RPN (mmdet's ``RPN`` over a ``GARPNHead``):
    ``forward_train`` gives the RPN losses on the guided anchors
    (``rpn_loss`` with SmoothL1 of ``rpn_beta``) with ``loss_anchor_loc``
    and ``loss_anchor_shape``; ``simple_test`` the post-NMS proposals as
    class-0 dets (B, max_num, 5). The guided anchors are decoded with unit
    stds whatever ``anchor_coder`` says (3aq); ``target_stds`` are the
    RPN's regression stds (``bbox_coder``)."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, octave_base_scale: float = 8.0,
                 scales_per_octave: int = 3, anchor_ratios=(0.5, 1.0, 2.0),
                 anchor_strides=(4, 8, 16, 32, 64),
                 target_stds=(0.07, 0.07, 0.14, 0.14),
                 ga_pos_iou_thr: float = 0.7, ga_neg_iou_thr: float = 0.3,
                 ga_min_pos_iou: float = 0.3, ga_sample_num: int = 256,
                 ga_pos_fraction: float = 0.5, rpn_pos_iou_thr: float = 0.7,
                 rpn_neg_iou_thr: float = 0.3, rpn_min_pos_iou: float = 0.3,
                 rpn_num_samples: int = 256, rpn_pos_fraction: float = 0.5,
                 center_ratio: float = 0.2, ignore_ratio: float = 0.5,
                 shape_beta: float = 0.2, rpn_beta: float = 1.0 / 9.0,
                 loc_filter_thr: float = 0.01, rpn_nms_pre_train: int = 2000,
                 rpn_nms_pre_test: int = 1000, rpn_max_num: int = 300,
                 rpn_nms_thr: float = 0.7):
        super().__init__(backbone, neck)
        self.rpn_head = rpn_head
        self._ga_init(octave_base_scale, scales_per_octave, anchor_ratios,
                      anchor_strides, UNIT_STDS, ga_pos_iou_thr,
                      ga_neg_iou_thr, ga_min_pos_iou, ga_sample_num,
                      ga_pos_fraction, center_ratio, ignore_ratio,
                      shape_beta, loc_filter_thr)
        self.target_stds = tuple(target_stds)
        self.rpn_assigner = MaxIoUAssigner(rpn_pos_iou_thr, rpn_neg_iou_thr,
                                           rpn_min_pos_iou,
                                           match_low_quality=True)
        self.rpn_sampler = RandomSampler(rpn_num_samples, rpn_pos_fraction)
        self.rpn_beta = rpn_beta
        self.rpn_nms_pre_train = rpn_nms_pre_train
        self.rpn_nms_pre_test = rpn_nms_pre_test
        self.rpn_max_num = rpn_max_num
        self.rpn_nms_thr = rpn_nms_thr

    def masked_cls(self, cls_scores, loc_preds) -> List[torch.Tensor]:
        """The objectness logits, -1e4 where the location filter drops the
        position."""
        return [torch.where(torch.sigmoid(lp.float()) >= self.loc_filter_thr,
                            cs.float(), -1e4)
                for cs, lp in zip(cls_scores, loc_preds)]

    def proposals(self, outs, sizes, batch, nms_pre: int):
        cls_scores, bbox_preds, shape_preds, loc_preds = outs
        squares = torch.cat(self.squares(sizes, cls_scores[0].device))
        guided = self.guided_anchors(squares, shape_preds)
        return rpn_get_proposals(
            self.masked_cls([c.detach() for c in cls_scores], loc_preds),
            [p.detach() for p in bbox_preds], _split_levels(guided, sizes),
            batch['img_shape'], nms_pre=nms_pre, max_num=self.rpn_max_num,
            nms_thr=self.rpn_nms_thr, target_stds=self.target_stds)

    def rpn_train(self, feats, batch, noise, generator):
        """The GA-RPN losses and, detached, the training proposals."""
        with record_function('rpn_loss'):
            outs = self.rpn_head(feats)
            cls_scores, bbox_preds, shape_preds, loc_preds = outs
            sizes = [tuple(f.shape[-2:]) for f in feats]
            squares = torch.cat(self.squares(sizes, feats[0].device))
            valid = self.square_valid(sizes, batch['img_shape'])
            loc = self.loc_loss(loc_preds, sizes, batch)
            shape = self.shape_loss(shape_preds, sizes, squares, valid, batch,
                                    noise, generator)
            b = cls_scores[0].shape[0]
            losses = rpn_loss(
                cls_scores, bbox_preds,
                self.guided_anchors(squares, shape_preds),
                valid[None].expand(b, -1), batch['gt_boxes'],
                batch['gt_valid'], self.rpn_assigner, self.rpn_sampler,
                ZERO_MEANS, self.target_stds, priorities=noise.get('rpn'),
                generator=generator, smoothl1_beta=self.rpn_beta)
            losses.update(loss_anchor_loc=loc, loss_anchor_shape=shape)
        with record_function('proposals'), torch.no_grad():
            proposals = self.proposals(outs, sizes, batch,
                                       self.rpn_nms_pre_train)
        return losses, proposals

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The GA-RPN losses; ``noise`` may hold the 'ga_pos' / 'ga_neg'
        shape-sampler and 'rpn' sampler draws (B, squares), else they come
        from ``generator``."""
        feats = self.extract_feat(self.images(batch))
        return self.rpn_train(feats, batch, noise or {}, generator)[0]

    def test_proposals(self, feats, batch):
        with record_function('rpn_and_proposals'):
            return self.proposals(self.rpn_head(feats),
                                  [tuple(f.shape[-2:]) for f in feats], batch,
                                  self.rpn_nms_pre_test)

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        props = self.test_proposals(self.extract_feat(self.images(batch)),
                                    batch)
        boxes = props.boxes
        if rescale:
            boxes = boxes / batch['scale_factor'][:, None, :].to(boxes.dtype)
        return {'dets': torch.cat([boxes, props.scores[..., None]], -1),
                'labels': torch.zeros(boxes.shape[:2], dtype=torch.int64,
                                      device=boxes.device),
                'det_valid': props.valid}


@DETECTORS.register_module()
class GAFasterRCNN(GARPN):
    """Faster R-CNN over the guided-anchor RPN (mmdet's ``FasterRCNN`` with
    a ``GARPNHead``): the GA-RPN's proposals through the RoI head."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, roi_head: nn.Module, **ga_cfg):
        super().__init__(backbone, neck, rpn_head, **ga_cfg)
        self.roi_head = roi_head

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The GA-RPN's losses and the RoI head's; ``noise`` may also hold
        the RoI head's 'rcnn' sampler priorities."""
        noise = noise or {}
        feats = self.extract_feat(self.images(batch))
        losses, proposals = self.rpn_train(feats, batch, noise, generator)
        losses.update(self.roi_head.forward_train(
            feats, proposals.boxes, proposals.valid, batch, noise, generator))
        return losses

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        feats = self.extract_feat(self.images(batch))
        props = self.test_proposals(feats, batch)
        return self.roi_head.simple_test(feats, props.boxes, props.valid,
                                         batch, rescale=rescale)
