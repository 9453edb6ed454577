"""RepPoints (port of ``dynamask_tpu/models/reppoints.py``): each location
predicts a set of 9 points (y-first offsets in stride units); two
exact-gather DCNs a level sample the towers at those points
(``layers.DeformConv2d``: the offsets roam past any window) for the class
scores and for a refinement of the points; a point set becomes a box by
its ``moment`` (mean +- std x exp of the learned ``moment_transfer``),
``minmax`` or ``partial_minmax`` (the first 4 points) transform.

The init stage trains on ``PointAssigner``'s positives, the refine stage
and the class scores on ``MaxIoUAssigner``'s over the detached init boxes;
SmoothL1 of the boxes over ``point_base_scale`` x stride. ``gradient_mul``
attenuates the gradient the DCN offsets send back into the init points
(``(1 - g) * p.detach() + g * p``), ``moment_mul`` that of the moment
transfer. ``use_grid_points`` (the ``bbox_r50_grid`` configs) regresses a
box (``gen_grid_from_reg``) whose 3x3 grid is the point set.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.assigners import MaxIoUAssigner, PointAssigner
from ..core.fp16 import at_least_f32
from ..utils.registry import DETECTORS, HEADS
from .layers import DeformConv2d, to_nchw, to_nhwc
from .losses import focal_elementwise, smooth_l1_elementwise
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv,
                           dense_get_dets, flatten_levels, head_conv,
                           one_hot_fg)


def points2bbox(pts_xy: torch.Tensor, method: str = 'moment',
                moment_transfer: Optional[torch.Tensor] = None,
                moment_mul: float = 0.01) -> torch.Tensor:
    """(..., P, 2) (x, y) points -> (..., 4) boxes by ``method``."""
    if method == 'partial_minmax':
        pts_xy = pts_xy[..., :4, :]
    if method in ('minmax', 'partial_minmax'):
        return torch.cat([pts_xy.min(-2).values, pts_xy.max(-2).values], -1)
    assert method == 'moment', method
    mean = pts_xy.mean(-2)
    std = (pts_xy - mean[..., None, :]).std(-2, unbiased=False)
    mt = moment_transfer * moment_mul + \
        moment_transfer.detach() * (1 - moment_mul)
    half_w = std[..., 0] * torch.exp(mt[0])
    half_h = std[..., 1] * torch.exp(mt[1])
    return torch.stack([mean[..., 0] - half_w, mean[..., 1] - half_h,
                        mean[..., 0] + half_w, mean[..., 1] + half_h], -1)


def gen_grid_from_reg(reg: torch.Tensor, prev_box: torch.Tensor, k: int):
    """A (..., 4) [dx, dy, dlog w, dlog h] regression against ``prev_box``
    -> (the new box's row-major k x k grid as y-first pairs (..., 2k^2),
    the box (..., 4))."""
    bxy = (prev_box[..., :2] + prev_box[..., 2:]) * 0.5
    bwh = (prev_box[..., 2:] - prev_box[..., :2]).clamp(min=1e-6)
    wh = bwh * torch.exp(reg[..., 2:])
    xy = bxy + bwh * reg[..., :2] - 0.5 * wh
    ratio = torch.linspace(0.0, 1.0, k, device=reg.device)
    gx = xy[..., 0:1] + ratio * wh[..., 0:1]
    gy = xy[..., 1:2] + ratio * wh[..., 1:2]
    yy = gy.repeat_interleave(k, -1)
    xx = gx.repeat((1,) * (gx.dim() - 1) + (k,))
    pts = torch.stack([yy, xx], -1).reshape(yy.shape[:-1] + (2 * k * k,))
    return pts, torch.cat([xy, xy + wh], -1)


@HEADS.register_module()
class RepPointsHead(nn.Module):
    """The towers (GN with ``gn_groups``, their convs then bias-free), the
    init branch (``reppoints_pts_init_conv`` 3x3, ``_out`` 1x1), the two
    DCNs (``reppoints_cls_conv``, ``reppoints_pts_refine_conv``) and their
    1x1 outputs, and ``moment_transfer`` (mmdet keeps it on the head, JAX
    on the detector). -> per level (B, C, H, W) scores and the fp32
    (B, 2P, H, W) init and refined points (4 box outputs under
    ``use_grid_points`` become the grid)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1, gn_groups: Optional[int] = 32,
                 use_grid_points: bool = False,
                 point_base_scale: float = 4.0):
        super().__init__()
        self.num_classes = num_classes
        self.k = int(num_points ** 0.5)
        self.gradient_mul = gradient_mul
        self.use_grid_points = use_grid_points
        self.point_base_scale = point_base_scale
        chans = [in_channels] + [feat_channels] * stacked_convs
        for tower in ('cls_convs', 'reg_convs'):
            setattr(self, tower, nn.ModuleList(
                [TowerConv(chans[i], chans[i + 1], bias=gn_groups is None,
                           gn_groups=gn_groups)
                 for i in range(stacked_convs)]))
        out_dim = 4 if use_grid_points else 2 * num_points
        self.reppoints_pts_init_conv = head_conv(feat_channels,
                                                 point_feat_channels)
        self.reppoints_pts_init_out = head_conv(point_feat_channels, out_dim,
                                                kernel=1)
        self.reppoints_cls_conv = DeformConv2d(feat_channels,
                                               point_feat_channels, self.k)
        self.reppoints_cls_out = head_conv(point_feat_channels, num_classes,
                                           bias_init=PRIOR_BIAS, kernel=1)
        self.reppoints_pts_refine_conv = DeformConv2d(
            feat_channels, point_feat_channels, self.k)
        self.reppoints_pts_refine_out = head_conv(point_feat_channels,
                                                  out_dim, kernel=1)
        self.moment_transfer = nn.Parameter(torch.zeros(2))

    def base_offset(self, device) -> torch.Tensor:
        """The (2k^2,) y-first offsets of the k x k kernel's taps."""
        pad = (self.k - 1) // 2
        base = torch.arange(-pad, pad + 1, dtype=torch.float32, device=device)
        return torch.stack([base.repeat_interleave(self.k),
                            base.repeat(self.k)], 1).reshape(-1)

    def forward(self, feats: Sequence[torch.Tensor]):
        cls_scores, inits, refines = [], [], []
        for x in feats:
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            pts_init = at_least_f32(to_nhwc(self.reppoints_pts_init_out(
                F.relu(self.reppoints_pts_init_conv(r)))))
            if self.use_grid_points:
                s = self.point_base_scale / 2.0
                prev = pts_init.new_tensor([-s, -s, s, s]).expand(
                    pts_init.shape[:-1] + (4,))
                pts_init, bbox_init = gen_grid_from_reg(pts_init, prev,
                                                        self.k)
            g = self.gradient_mul
            mix = (1 - g) * pts_init.detach() + g * pts_init
            offset = to_nchw(mix - self.base_offset(x.device))
            cls_scores.append(self.reppoints_cls_out(F.relu(
                self.reppoints_cls_conv(c, offset))))
            ref = at_least_f32(to_nhwc(self.reppoints_pts_refine_out(
                F.relu(self.reppoints_pts_refine_conv(r, offset)))))
            if self.use_grid_points:
                ref = gen_grid_from_reg(ref, bbox_init.detach(), self.k)[0]
            else:
                ref = ref + pts_init.detach()
            inits.append(to_nchw(pts_init))
            refines.append(to_nchw(ref))
        return cls_scores, inits, refines


def reppoints_points(sizes, strides, device=None):
    """Per level the (H*W, 3) [x, y, stride] of each location: ``(j * s,
    i * s)``, no half-cell shift (mmdet's point generator)."""
    out = []
    for (h, w), s in zip(sizes, strides):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device) * s,
            torch.arange(w, dtype=torch.float32, device=device) * s,
            indexing='ij')
        out.append(torch.stack([gx.reshape(-1), gy.reshape(-1),
                                torch.full((h * w,), float(s),
                                           device=device)], -1))
    return out


@DETECTORS.register_module()
class RepPointsDetector(DenseDetector):
    """mmdet's ``RepPointsDetector``, as JAX's."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: RepPointsHead, num_classes: int = 80,
                 num_points: int = 9, point_strides=(8, 16, 32, 64, 128),
                 point_base_scale: float = 4.0, moment_mul: float = 0.01,
                 transform_method: str = 'moment',
                 init_assign_scale: float = 4.0, init_pos_num: int = 1,
                 refine_pos_iou: float = 0.5, refine_neg_iou: float = 0.4,
                 loss_init_weight: float = 0.5,
                 loss_refine_weight: float = 1.0,
                 smoothl1_beta: float = 1.0 / 9.0, nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.num_points = num_points
        self.point_strides = tuple(point_strides)
        self.point_base_scale = point_base_scale
        self.moment_mul = moment_mul
        self.transform_method = transform_method
        self.init_assigner = PointAssigner(init_assign_scale, init_pos_num)
        self.refine_assigner = MaxIoUAssigner(refine_pos_iou, refine_neg_iou,
                                              0.0, match_low_quality=True)
        self.loss_init_weight = loss_init_weight
        self.loss_refine_weight = loss_refine_weight
        self.smoothl1_beta = smoothl1_beta

    def boxes(self, points: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """[x, y, stride] ``points`` (..., 3) and their (..., 2P) y-first
        offsets -> boxes (..., 4)."""
        p = pts.reshape(pts.shape[:-1] + (self.num_points, 2))
        xy = torch.stack([p[..., 1], p[..., 0]], -1) * points[..., None, 2:3] \
            + points[..., None, :2]
        return points2bbox(xy, self.transform_method,
                           self.bbox_head.moment_transfer, self.moment_mul)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """``loss_cls``, ``loss_pts_init`` and ``loss_pts_refine`` of one
        padded batch; nothing is drawn, every location takes part."""
        feats, (cls_scores, pts_inits, pts_refines) = self.head(batch)
        with record_function('loss'):
            points = torch.cat(reppoints_points(
                [tuple(f.shape[-2:]) for f in feats], self.point_strides,
                feats[0].device))
            norm = (self.point_base_scale * points[:, 2])[:, None]
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            two_p = 2 * self.num_points
            bbox_init = self.boxes(points, flatten_levels(pts_inits, two_p))
            bbox_refine = self.boxes(points,
                                     flatten_levels(pts_refines, two_p))
            valid = torch.ones(points.shape[0], dtype=torch.bool,
                               device=points.device)
            gt_boxes = batch['gt_boxes']
            top = gt_boxes.shape[1] - 1
            cls_l, init_l, refine_l, np_i, np_r = 0, 0, 0, 0, 0
            for i in range(flat_cls.shape[0]):
                gvalid, glabels = batch['gt_valid'][i], batch['gt_labels'][i]
                a = self.init_assigner(points, valid, gt_boxes[i], gvalid,
                                       glabels)
                pos_i = (a.gt_inds > 0).float()
                tgt = gt_boxes[i][(a.gt_inds - 1).clamp(0, top)]
                init_l = init_l + (smooth_l1_elementwise(
                    bbox_init[i] / norm, tgt / norm, self.smoothl1_beta) *
                    pos_i[:, None]).sum()
                a = self.refine_assigner(bbox_init[i].detach(), valid,
                                         gt_boxes[i], gvalid, glabels)
                pos_r = (a.gt_inds > 0).float()
                tgt = gt_boxes[i][(a.gt_inds - 1).clamp(0, top)]
                refine_l = refine_l + (smooth_l1_elementwise(
                    bbox_refine[i] / norm, tgt / norm, self.smoothl1_beta) *
                    pos_r[:, None]).sum()
                onehot = one_hot_fg(a.labels.clamp(min=0), pos_r > 0,
                                    self.num_classes)
                cls_l = cls_l + (focal_elementwise(flat_cls[i], onehot) *
                                 (a.gt_inds >= 0).float()[:, None]).sum()
                np_i = np_i + pos_i.sum()
                np_r = np_r + pos_r.sum()
            avg_i = torch.as_tensor(np_i).clamp(min=1.0)
            avg_r = torch.as_tensor(np_r).clamp(min=1.0)
            return {'loss_cls': cls_l / avg_r,
                    'loss_pts_init': self.loss_init_weight * init_l / avg_i,
                    'loss_pts_refine':
                        self.loss_refine_weight * refine_l / avg_r}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """The refined points' boxes."""
        feats, (cls_scores, _, pts_refines) = self.head(batch)
        with record_function('get_dets'):
            points = reppoints_points([tuple(f.shape[-2:]) for f in feats],
                                      self.point_strides, feats[0].device)
            return dense_get_dets(cls_scores, pts_refines, points, batch,
                                  self.num_classes, self.boxes,
                                  rescale=rescale,
                                  reg_channels=2 * self.num_points,
                                  **self.test_cfg)
