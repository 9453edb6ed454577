"""FCOS (port of ``dynamask_tpu/models/fcos.py``): per-location class
scores, (left, top, right, bottom) distances through a learnable ``Scale``
a level, and a centerness branch; each location is assigned to the
smallest GT that contains it (or, with ``center_sampling``, whose
``center_sample_radius`` x stride box around its centre contains it) and
whose size falls in the level's regress range.

The distances are absolute pixels on both paths, as in JAX: ``exp`` of the
scaled output, or its ReLU with ``norm_on_bbox``, times the level's stride
(mmdet's ``norm_on_bbox`` regresses stride units in training, and without
it regresses ``exp`` alone: ROADMAP.md queue 3, 3ae). The losses are
JAX's (``fcos.py:252-290``): focal at gamma 2 and alpha 0.25 over every
location, the IoU loss (``giou``, or ``log_iou`` for mmdet's ``IoULoss``)
weighted by the centerness target over each image's centerness sum and
averaged over the images, centerness BCE.

``dcn_on_last_conv`` makes the last conv of both towers a 3x3 DCNv1 with
its own offset conv (JAX ``:83-104``, ``layers.DeformConv2dPack`` through
the exact gather), initialised N(0, 0.01) as the tower's convs and bias
free; mmdet's names it ``{cls,reg}_convs.{i}.conv``, its offsets
``.conv_offset``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.bbox_transforms import distance2bbox
from ..utils.registry import DETECTORS, HEADS
from .atss import Scale
from .layers import DeformConv2dPack, WeightFaults
from .losses import (binary_cross_entropy_with_logits, focal_elementwise,
                     iou_loss)
from .single_stage import (PRIOR_BIAS, DenseDetector, TowerConv,
                           dense_get_dets, flatten_levels, head_conv,
                           one_hot_fg)

INF = 1e8


@HEADS.register_module()
class FCOSHead(WeightFaults, nn.Module):
    """Cls and reg towers (GroupNorm with ``gn_groups``, their convs then
    bias-free, or no norm), ``conv_cls`` (the prior bias), ``conv_reg``
    and ``conv_centerness`` (on the cls tower, or on the reg tower with
    ``centerness_on_reg``)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 strides: Sequence[int] = (8, 16, 32, 64, 128),
                 gn_groups: Optional[int] = None,
                 centerness_on_reg: bool = False,
                 norm_on_bbox: bool = False,
                 dcn_on_last_conv: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.centerness_on_reg = centerness_on_reg
        self.norm_on_bbox = norm_on_bbox
        chans = [in_channels] + [feat_channels] * stacked_convs
        self.cls_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], bias=gn_groups is None,
                       gn_groups=gn_groups) for i in range(stacked_convs)])
        self.reg_convs = nn.ModuleList(
            [TowerConv(chans[i], chans[i + 1], bias=gn_groups is None,
                       gn_groups=gn_groups) for i in range(stacked_convs)])
        if dcn_on_last_conv and stacked_convs:
            for tower in (self.cls_convs, self.reg_convs):
                dcn = DeformConv2dPack(chans[-2], chans[-1])
                dcn.init_rule = 0.01
                tower[-1].conv = dcn
        self.conv_cls = head_conv(chans[-1], num_classes,
                                  bias_init=PRIOR_BIAS)
        self.conv_reg = head_conv(chans[-1], 4)
        self.conv_centerness = head_conv(chans[-1], 1)
        self.scales = nn.ModuleList([Scale() for _ in self.strides])

    def weight_fault(self, key: str, shape) -> Optional[str]:
        """A ``conv_offset`` of another width than this head's DCNv1 (an
        mmdet checkpoint's DCNv2 offsets and mask, 27 channels) is refused
        on load; it is never cut."""
        parts = key.split('.')
        if len(parts) != 5 or parts[2:4] != ['conv', 'conv_offset']:
            return None
        try:
            conv = getattr(self, parts[0])[int(parts[1])].conv
        except (AttributeError, IndexError, ValueError):
            return None
        want = tuple(getattr(conv.conv_offset, parts[4]).shape)
        if not isinstance(conv, DeformConv2dPack) or tuple(shape) == want:
            return None
        return (f'{key}: the checkpoint\'s {tuple(shape)} does not fit this '
                f'head\'s DCNv1 offsets {want} (the JAX package builds '
                '``dcn_on_last_conv`` as DCNv1; ROADMAP.md queue 3)')

    def forward(self, feats: Sequence[torch.Tensor]):
        """-> per level (B, C, H, W) scores, (B, 4, H, W) fp32 distances in
        pixels, (B, 1, H, W) centerness logits."""
        cls_out, reg_out, cent_out = [], [], []
        for x, scale, stride in zip(feats, self.scales, self.strides):
            c, r = x, x
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_out.append(self.conv_cls(c))
            cent_out.append(self.conv_centerness(
                r if self.centerness_on_reg else c))
            raw = scale(self.conv_reg(r).float())
            reg = F.relu(raw) if self.norm_on_bbox else torch.exp(raw)
            reg_out.append(reg * stride)
        return cls_out, reg_out, cent_out


def fcos_points(featmap_sizes, strides, device=None) -> List[torch.Tensor]:
    """Per level the (H*W, 2) (x, y) location centres, ``(i + 0.5) *
    stride``, row-major."""
    pts = []
    for (h, w), s in zip(featmap_sizes, strides):
        ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * s
        xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * s
        gy, gx = torch.meshgrid(ys, xs, indexing='ij')
        pts.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return pts


def fcos_targets(points: torch.Tensor, regress_ranges: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                 gt_valid: torch.Tensor, num_classes: int,
                 point_strides: Optional[torch.Tensor] = None,
                 center_sample_radius: float = 1.5
                 ) -> Tuple[torch.Tensor, ...]:
    """One image's dense targets (JAX ``fcos_targets``): labels (K,)
    (``num_classes`` on a negative), the (K, 4) ltrb distances to the
    assigned GT, the centerness target and the positive mask.
    ``point_strides`` (K,) turns on center sampling."""
    valid = gt_valid.bool()
    areas = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] -
                                                 gt_boxes[:, 1])
    areas = torch.where(valid, areas, INF)
    xs, ys = points[:, 0:1], points[:, 1:2]
    ltrb = torch.stack([xs - gt_boxes[None, :, 0], ys - gt_boxes[None, :, 1],
                        gt_boxes[None, :, 2] - xs, gt_boxes[None, :, 3] - ys],
                       -1)                                    # (K, G, 4)
    if point_strides is not None:
        r = point_strides[:, None] * center_sample_radius
        cx = (gt_boxes[None, :, 0] + gt_boxes[None, :, 2]) * 0.5
        cy = (gt_boxes[None, :, 1] + gt_boxes[None, :, 3]) * 0.5
        x1 = torch.maximum(cx - r, gt_boxes[None, :, 0])
        y1 = torch.maximum(cy - r, gt_boxes[None, :, 1])
        x2 = torch.minimum(cx + r, gt_boxes[None, :, 2])
        y2 = torch.minimum(cy + r, gt_boxes[None, :, 3])
        inside = (xs > x1) & (xs < x2) & (ys > y1) & (ys < y2)
    else:
        inside = ltrb.min(-1).values > 0
    max_dist = ltrb.max(-1).values
    in_range = (max_dist >= regress_ranges[:, 0:1]) & \
        (max_dist <= regress_ranges[:, 1:2])
    candidate = inside & in_range & valid[None, :]
    area_mat = torch.where(candidate, areas[None, :], INF)
    min_area, gt_idx = area_mat.min(-1).values, area_mat.argmin(-1)
    pos = min_area < INF
    labels = torch.where(pos, gt_labels.long()[gt_idx], num_classes)
    tgt = ltrb.gather(1, gt_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    lr, tb = tgt[:, 0::2], tgt[:, 1::2]
    cent = torch.sqrt(((lr.min(-1).values / lr.max(-1).values.clamp(min=1e-6))
                       * (tb.min(-1).values /
                          tb.max(-1).values.clamp(min=1e-6))).clamp(0, 1))
    return labels, tgt, cent, pos


@DETECTORS.register_module()
class FCOS(DenseDetector):
    """mmdet's ``FCOS`` detector, as JAX's ``FCOS``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 bbox_head: FCOSHead, num_classes: int = 80,
                 regress_ranges=((-1, 64), (64, 128), (128, 256), (256, 512),
                                 (512, INF)),
                 center_sampling: bool = False,
                 center_sample_radius: float = 1.5,
                 reg_loss_mode: str = 'giou', nms_pre: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 max_per_img: int = 100):
        super().__init__(backbone, neck, bbox_head, num_classes, nms_pre,
                         score_thr, nms_iou_thr, max_per_img)
        self.strides = bbox_head.strides
        self.regress_ranges = tuple(tuple(float(v) for v in r)
                                    for r in regress_ranges)
        self.center_sampling = center_sampling
        self.center_sample_radius = center_sample_radius
        self.reg_loss_mode = reg_loss_mode

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The three losses of one padded batch; nothing is drawn. Every
        location takes part, as in JAX (no valid flags)."""
        feats, (cls_scores, bbox_preds, cent_preds) = self.head(batch)
        with record_function('loss'):
            dev = feats[0].device
            pts = fcos_points([tuple(f.shape[-2:]) for f in feats],
                              self.strides, dev)
            all_pts = torch.cat(pts)
            rr = torch.cat([torch.tensor(r, device=dev).expand(p.shape[0], 2)
                            for r, p in zip(self.regress_ranges, pts)])
            strides = torch.cat([torch.full((p.shape[0],), float(s),
                                            device=dev)
                                 for p, s in zip(pts, self.strides)]) \
                if self.center_sampling else None
            flat_cls = flatten_levels(cls_scores, self.num_classes)
            flat_reg = flatten_levels(bbox_preds, 4)
            flat_cent = flatten_levels(cent_preds, 1)[..., 0]
            cls_l, iou_l, cent_l, num_pos = 0, [], 0, 0
            for i in range(flat_cls.shape[0]):
                labels, tgt, cent_t, pos = fcos_targets(
                    all_pts, rr, batch['gt_boxes'][i], batch['gt_labels'][i],
                    batch['gt_valid'][i], self.num_classes, strides,
                    self.center_sample_radius)
                onehot = one_hot_fg(labels, pos, self.num_classes)
                cls_l = cls_l + focal_elementwise(flat_cls[i], onehot).sum()
                w = pos.float() * cent_t
                iou_l.append(iou_loss(
                    distance2bbox(all_pts, flat_reg[i]),
                    distance2bbox(all_pts, tgt), mode=self.reg_loss_mode,
                    weight=w, avg_factor=w.sum()))
                cent_l = cent_l + (binary_cross_entropy_with_logits(
                    flat_cent[i], cent_t) * pos).sum()
                num_pos = num_pos + pos.sum()
            avg = torch.as_tensor(num_pos).float().clamp(min=1.0)
            return {'loss_cls': cls_l / avg,
                    'loss_bbox': torch.stack(iou_l).mean(),
                    'loss_centerness': cent_l / avg}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Scores are the class sigmoid times the centerness sigmoid;
        :func:`~dynamask_torch.models.single_stage.dense_get_dets` over
        the locations, their distances decoded."""
        feats, (cls_scores, bbox_preds, cent_preds) = self.head(batch)
        with record_function('get_dets'):
            pts = fcos_points([tuple(f.shape[-2:]) for f in feats],
                              self.strides, feats[0].device)
            return dense_get_dets(cls_scores, bbox_preds, pts, batch,
                                  self.num_classes, distance2bbox,
                                  cent_preds, rescale=rescale,
                                  **self.test_cfg)
