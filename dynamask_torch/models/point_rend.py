"""PointRend's RoI head (port of ``dynamask_tpu/models/point_rend.py``:
``grid_point_sample`` :33, ``CoarseMaskHead`` :65, ``MaskPointHead``
:103, ``point_uncertainty`` :129, ``PointRendRoIHead`` :141).

A coarse 7x7 mask from fcs over a 14x14 crop of P2 alone (K2 at sampling
ratio 1, the JAX package's ``simple_roi_align``; K4 in the backward), and
a point MLP that re-classifies points from P2's features at them
(:func:`ops.point_sample.point_sample`) and the coarse logits there. In
training it takes ``oversample_ratio * num_points`` uniform points, keeps
the ``importance_sample_ratio`` most uncertain and adds uniform ones; at
inference the mask is upsampled x2 ``subdivision_steps`` times, each
step's ``subdivision_num_points`` most uncertain points replaced by the
point head's logits (7² to 224² at the config's 5 steps).

Module names are mmdet's: ``mask_head.{convs.i.conv, downsample_conv.conv,
fcs.i, fc_logits}`` (``fc_logits`` rows in mmdet's (class, y, x) order)
and ``point_head.{fcs.i.conv, fc_logits}`` (1x1 ``Conv1d`` kernels).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import interpolate_bilinear
from ..core.mask_targets import mask_targets_from_crops
from ..ops.point_sample import (point_sample, rel_roi_points_to_img_points,
                                top_k)
from ..ops.roi_align import simple_roi_align
from ..utils.registry import HEADS
from .fcn_mask_head import select_class_channel
from .layers import ConvModule, to_nchw, to_nhwc
from .losses import binary_cross_entropy_with_logits
from .roi_head import StandardRoIHead


def grid_point_sample(maps: torch.Tensor, rel_points: torch.Tensor
                      ) -> torch.Tensor:
    """Per-RoI NHWC ``maps`` (R, h, w, C) at unit-square points (R, P, 2)
    (x, y) -> (R, P, C): bilinear at ``x * w - 0.5``, the corner indices
    and the weights clamped to the map (JAX ``point_rend.py:44-53``;
    mmcv's ``point_sample`` pads with zeros, ROADMAP.md queue 3)."""
    r, h, w, c = maps.shape
    xs = rel_points[..., 0] * w - 0.5
    ys = rel_points[..., 1] * h - 0.5
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    lx = (xs - x0).clamp(0.0, 1.0)
    ly = (ys - y0).clamp(0.0, 1.0)
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    flat = maps.reshape(r * h * w, c)
    base = (torch.arange(r, device=maps.device) * (h * w))[:, None]

    def g(yi, xi):
        return flat.index_select(0, (base + yi * w + xi).reshape(-1)) \
            .reshape(*yi.shape, c)

    return (g(y0i, x0i) * ((1 - ly) * (1 - lx))[..., None] +
            g(y0i, x1i) * ((1 - ly) * lx)[..., None] +
            g(y1i, x0i) * (ly * (1 - lx))[..., None] +
            g(y1i, x1i) * (ly * lx)[..., None])


@HEADS.register_module()
class CoarseMaskHead(nn.Module):
    """``num_convs`` 3x3 convs, a ``downsample_factor`` strided conv, then
    ``num_fcs`` fcs (each with ReLU) to a (roi // factor)² mask a class.
    ``forward`` (N, C, roi, roi) -> (N, num_classes, s, s)."""

    def __init__(self, num_convs: int = 0, num_fcs: int = 2,
                 in_channels: int = 256, conv_out_channels: int = 256,
                 fc_out_channels: int = 1024, downsample_factor: int = 2,
                 roi_feat_size: int = 14, num_classes: int = 80):
        super().__init__()
        self.num_classes = num_classes
        self.out_size = roi_feat_size // downsample_factor
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1)
            for i in range(num_convs))
        last = conv_out_channels if num_convs else in_channels
        if downsample_factor > 1:
            self.downsample_conv = ConvModule(last, conv_out_channels,
                                              downsample_factor,
                                              stride=downsample_factor)
            last = conv_out_channels
        fcs, width = [], last * self.out_size ** 2
        for _ in range(num_fcs):
            fc = nn.Linear(width, fc_out_channels)
            fc.init_rule = 'lecun'      # flax's default Dense init
            fcs.append(fc)
            width = fc_out_channels
        self.fcs = nn.ModuleList(fcs)
        self.fc_logits = nn.Linear(width, num_classes * self.out_size ** 2)
        self.fc_logits.init_rule = 0.001

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.relu(conv(x))
        if hasattr(self, 'downsample_conv'):
            x = F.relu(self.downsample_conv(x))
        x = x.reshape(x.shape[0], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
        s = self.out_size
        return self.fc_logits(x).reshape(x.shape[0], self.num_classes, s, s)


class PointConv(nn.Module):
    """mmcv's ``ConvModule(conv_cfg=Conv1d)`` naming: a 1x1 ``Conv1d``
    under ``.conv``, applied to (R, P, C) point features as a dense
    layer."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, out_channels, 1)
        self.conv.init_rule = 'lecun'

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return point_linear(self.conv, x)


def point_linear(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv1d`` over the last axis of (..., C)."""
    return F.linear(x, conv.weight[..., 0], conv.bias)


class PointMLP(nn.Module):
    """``fcs`` (each with ReLU, the ``coarse`` features appended after
    each with ``coarse_pred_each_layer``) over the fine features and the
    coarse ones side by side, then ``fc_logits``: (R, P, C_fine),
    (R, P, C_coarse) -> (R, P, out_channels)."""

    def __init__(self, in_channels: int, coarse_channels: int,
                 fc_channels: int, num_fcs: int, out_channels: int,
                 coarse_pred_each_layer: bool = True,
                 logits_std: Optional[float] = None):
        super().__init__()
        self.coarse_pred_each_layer = coarse_pred_each_layer
        extra = coarse_channels if coarse_pred_each_layer else 0
        width = in_channels + coarse_channels
        self.fcs = nn.ModuleList()
        for _ in range(num_fcs):
            self.fcs.append(PointConv(width, fc_channels))
            width = fc_channels + extra
        self.fc_logits = nn.Conv1d(width, out_channels, 1)
        self.fc_logits.init_rule = 'lecun' if logits_std is None \
            else logits_std

    def forward(self, fine: torch.Tensor, coarse: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([fine, coarse], -1)
        for fc in self.fcs:
            x = F.relu(fc(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], -1)
        return point_linear(self.fc_logits, x)


@HEADS.register_module()
class MaskPointHead(PointMLP):
    """The point head: (R, P, C) fine features and (R, P, num_classes)
    coarse logits -> (R, P, num_classes) point logits (one a point when
    ``class_agnostic``)."""

    def __init__(self, num_classes: int = 80, num_fcs: int = 3,
                 in_channels: int = 256, fc_channels: int = 256,
                 class_agnostic: bool = False,
                 coarse_pred_each_layer: bool = True):
        super().__init__(in_channels, num_classes, fc_channels, num_fcs,
                         1 if class_agnostic else num_classes,
                         coarse_pred_each_layer, logits_std=0.001)


def point_uncertainty(logits: torch.Tensor, labels: torch.Tensor
                      ) -> torch.Tensor:
    """-|logit of the RoI's class| at each point: (R, P, C), (R,) ->
    (R, P)."""
    return -select_points_class(logits, labels).abs()


def select_points_class(logits: torch.Tensor, labels: torch.Tensor
                        ) -> torch.Tensor:
    """(R, P, C), (R,) -> (R, P): each RoI's class, clamped into range."""
    c = logits.shape[-1]
    safe = labels.long().clamp(0, c - 1)
    return logits.gather(-1, safe[:, None, None].expand(
        -1, logits.shape[1], 1))[..., 0]


@HEADS.register_module()
class PointRendRoIHead(StandardRoIHead):
    """``StandardRoIHead`` with a ``CoarseMaskHead`` over P2's 14x14 crop
    and a ``MaskPointHead``. Its training draws (``noise`` 'point_over'
    (R, oversample_ratio * num_points, 2) and 'point_rand' (R, num_points
    - importance points, 2) uniforms, R the positive slots) come from the
    generator when not given."""

    def __init__(self, bbox_head, mask_head: CoarseMaskHead,
                 point_head: MaskPointHead, num_points: int = 196,
                 oversample_ratio: float = 3.0,
                 importance_sample_ratio: float = 0.75,
                 subdivision_steps: int = 5,
                 subdivision_num_points: int = 784, scale_factor: int = 2,
                 point_feat_stride: int = 4, **common):
        super().__init__(bbox_head, mask_head, **common)
        self.point_head = point_head
        self.num_points = num_points
        self.oversample_ratio = oversample_ratio
        self.importance_sample_ratio = importance_sample_ratio
        self.subdivision_steps = subdivision_steps
        self.subdivision_num_points = subdivision_num_points
        self.scale_factor = scale_factor
        self.point_feat_stride = point_feat_stride

    def _coarse_logits(self, feats, rois, roi_batch) -> torch.Tensor:
        """The coarse head on the RoIs' ``mask_roi_out`` crop of P2 alone
        at ratio 1 (K2; the JAX package's ``simple_roi_align``)."""
        crop = simple_roi_align(to_nhwc(feats[0]), rois, roi_batch,
                                self.mask_roi_out,
                                1.0 / self.point_feat_stride)
        return self.mask_head(to_nchw(crop))

    def _fine_grained(self, feats, rois, roi_batch, rel_points):
        return point_sample(to_nhwc(feats[0]), rel_roi_points_to_img_points(
            rois, rel_points, 1.0 / self.point_feat_stride), roi_batch)

    def _mask_draws(self, noise: dict):
        return noise.get('point_over'), noise.get('point_rand')

    def _mask_forward_train(self, feats, sample, batch, draws=None,
                            generator=None):
        """The coarse mask BCE at its size, and the point BCE at the
        importance-sampled points against the 56x56 targets sampled
        there."""
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        coarse = self._coarse_logits(feats, boxes, roi_batch)
        r, s = coarse.shape[0], coarse.shape[-1]
        coarse_t = mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], s)
        pred = select_class_channel(coarse, labels)
        per = binary_cross_entropy_with_logits(pred.float(), coarse_t)
        v = valid.float()
        nv = v.sum().clamp(min=1.0)
        loss_mask = (per.mean((1, 2)) * v).sum() / nv

        n_over = int(self.num_points * self.oversample_ratio)
        n_imp = int(self.importance_sample_ratio * self.num_points)
        n_rand = self.num_points - n_imp
        over_u, rand_u = draws or (None, None)
        dev = coarse.device
        if over_u is None:
            over_u = torch.rand(r, n_over, 2, generator=generator, device=dev)
        if rand_u is None:
            rand_u = torch.rand(r, n_rand, 2, generator=generator, device=dev)
        over_u, rand_u = over_u.to(dev).float(), rand_u.to(dev).float()
        coarse_hwc = coarse.permute(0, 2, 3, 1)
        with torch.no_grad():
            unc = point_uncertainty(grid_point_sample(coarse_hwc.float(),
                                                      over_u), labels)
            _, top = top_k(unc, n_imp)
        imp = over_u.gather(1, top[..., None].expand(-1, -1, 2))
        pts = torch.cat([imp, rand_u], 1)
        fine = self._fine_grained(feats, boxes, roi_batch, pts)
        logits = self.point_head(fine, grid_point_sample(coarse_hwc, pts))
        tgt = mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], 56)
        point_t = (grid_point_sample(tgt[..., None], pts)[..., 0] >= 0.5
                   ).float()
        per_pt = binary_cross_entropy_with_logits(
            select_points_class(logits, labels).float(), point_t)
        loss_point = (per_pt.mean(1) * v).sum() / nv
        return {'loss_mask': self.loss_mask_weight * loss_mask,
                'loss_point': loss_point}

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        """(B, D, s, s) mask probabilities, s = 7 * scale_factor **
        subdivision_steps: the coarse mask of each det's class refined
        step by step."""
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        flat_labels = labels.reshape(b * d)
        coarse = self._coarse_logits(feats, rois, roi_batch).float()
        coarse_hwc = coarse.permute(0, 2, 3, 1)
        refined = select_class_channel(coarse, flat_labels)     # (R, h, w)
        for _ in range(self.subdivision_steps):
            r, h, w = refined.shape
            nh, nw = h * self.scale_factor, w * self.scale_factor
            up = interpolate_bilinear(refined, nh, nw, align_corners=False)
            npts = min(self.subdivision_num_points, nh * nw)
            upf = up.reshape(r, nh * nw)
            _, idx = top_k(-upf.abs(), npts)
            pts = torch.stack([((idx % nw).float() + 0.5) / nw,
                               ((idx // nw).float() + 0.5) / nh], -1)
            fine = self._fine_grained(feats, rois, roi_batch, pts)
            plog = self.point_head(fine, grid_point_sample(coarse_hwc, pts))
            psel = select_points_class(plog.float(), flat_labels)
            refined = upf.scatter(1, idx, psel).reshape(r, nh, nw)
        probs = torch.sigmoid(refined)
        return probs.reshape(b, d, *probs.shape[1:])
