"""PointRefine, the PointRend-style experiment of the DynaMask reference
(port of ``dynamask_tpu/models/point_refine_head.py``: ``PointSFMStage``
:36, ``PointRefineMaskHead`` :112, ``PointRefineRoIHead`` :179).

RefineMask's semantic tower over P2 and a 14→28→56→112 instance cascade
in which each stage refines its ``num_points`` most "detailed" positions
(the top of its detail map, JAX's tie order, :func:`ops.point_sample.
top_k`): an MLP over the transformed semantic features sampled there
(:func:`ops.point_sample.point_sample`) and the stage's instance and
detail logits at them, written back into the stage's features before the
x2 upsample. The crops are the RoI head's box and mask extracts (K2; K4 in
the backward); the points read P2 through plain gathers, as XLA does in
JAX.

The reference config names a ``PointRefineCrossEntropyLoss`` that the
reference lacks (JAX ``point_refine_head.py:10-15``); the port computes
JAX's supervision: per stage the instance BCE and the detail BCE against
the Laplacian boundary targets, both weighed by the stage's weight, and
the semantic BCE.

Names follow the RefineMask heads' (``instance_convs.i.conv``,
``semantic_convs.i.conv``, ``semantic_logits``, ``stages.i.
{semantic_transform_in, instance_logits, detail_logits, fuse_transform_out}``,
``final_instance_logits``, ``final_detail_logits``) and mmdet's point
head's for each stage's MLP (``stages.i.fcs.j.conv``, ``stages.i.
fc_logits``, 1x1 ``Conv1d`` kernels).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import detail_target
from ..core.mask_targets import mask_targets_from_crops
from ..ops.point_sample import (point_sample, rel_roi_points_to_img_points,
                                top_k)
from ..utils.registry import HEADS
from .fcn_mask_head import select_class_channel
from .layers import resize_bilinear_2x, to_nchw, to_nhwc
from .losses import binary_cross_entropy_with_logits
from .point_rend import PointMLP
from .refine_mask_head import RefineRoIHead, _Towers


def _select(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W), (N,) -> (N, 1, H, W): each RoI's class map."""
    return select_class_channel(logits, labels)[:, None]


class PointSFMStage(PointMLP):
    """One stage: (N, c, s, s) instance features -> the class-selected
    instance and detail logits (N, 1, s, s) and the refined features
    (N, out, 2s, 2s). The point MLP (``fcs``, ``fc_logits``) is its
    ``PointMLP`` part."""

    def __init__(self, semantic_in_channel: int, in_channel: int,
                 out_channel: int, num_fcs: int, num_classes: int,
                 num_points: int, semantic_out_stride: int = 4,
                 mask_use_sigmoid: bool = False,
                 coarse_pred_each_layer: bool = True):
        super().__init__(in_channel, 2 * num_classes, in_channel, num_fcs,
                         in_channel, coarse_pred_each_layer)
        self.num_points = num_points
        self.scale = 1.0 / semantic_out_stride
        self.mask_use_sigmoid = mask_use_sigmoid
        self.semantic_transform_in = nn.Conv2d(semantic_in_channel,
                                               in_channel, 1)
        self.instance_logits = nn.Conv2d(in_channel, num_classes, 1)
        self.detail_logits = nn.Conv2d(in_channel, num_classes, 1)
        self.fuse_transform_out = nn.Conv2d(in_channel, out_channel, 1)

    def forward(self, instance_feats, semantic_feat, rois, roi_batch,
                roi_labels):
        r, c, mh, mw = instance_feats.shape
        k = min(self.num_points, mh * mw)
        sem = F.relu(self.semantic_transform_in(semantic_feat))
        inst_logits = self.instance_logits(instance_feats)
        det_logits = self.detail_logits(instance_feats)
        inst = _select(inst_logits, roi_labels)
        det = _select(det_logits, roi_labels)
        with torch.no_grad():
            det_map = torch.sigmoid(det) if self.mask_use_sigmoid else det
            _, idx = top_k(det_map[:, 0].reshape(r, -1), k)      # (R, P)
        rel = torch.stack([((idx % mw).float() + 0.5) / mw,
                           ((idx // mw).float() + 0.5) / mh], -1)
        fine = point_sample(to_nhwc(sem), rel_roi_points_to_img_points(
            rois, rel, self.scale), roi_batch)                   # (R, P, c)

        def at_points(maps):            # (R, C, s, s) -> (R, P, C)
            flat = maps.permute(0, 2, 3, 1).reshape(r, mh * mw, -1)
            return flat.gather(1, idx[..., None].expand(-1, -1,
                                                        flat.shape[-1]))

        coarse = torch.cat([at_points(inst_logits), at_points(det_logits)],
                           -1)
        x = super().forward(fine, coarse)                        # (R, P, c)
        flat = to_nhwc(instance_feats).reshape(r, mh * mw, c)
        refined = flat.scatter(1, idx[..., None].expand(-1, -1, c), x)
        out = F.relu(self.fuse_transform_out(to_nchw(
            refined.reshape(r, mh, mw, c))))
        out = F.relu(resize_bilinear_2x(out, align_corners=False))
        return inst, det, out.contiguous(memory_format=torch.channels_last)


@HEADS.register_module()
class PointRefineMaskHead(_Towers):
    """The towers, the semantic logits, three ``PointSFMStage``s and the
    final stage's logits. ``forward`` returns the per-stage class-selected
    instance and detail logits [(N, 1, s, s)] at ``stage_sup_size`` and the
    semantic logits (B, 1, H/4, W/4) of P2."""

    def __init__(self, num_convs_instance: int = 2,
                 num_convs_semantic: int = 4, num_fcs: int = 3,
                 conv_in_channels_instance: int = 256,
                 conv_in_channels_semantic: int = 256,
                 conv_out_channels_instance: int = 256,
                 conv_out_channels_semantic: int = 256,
                 semantic_out_stride: int = 4,
                 mask_use_sigmoid: bool = False,
                 coarse_pred_each_layer: bool = True,
                 stage_num_classes: Sequence[int] = (80, 80, 80, 80),
                 stage_sup_size: Sequence[int] = (14, 28, 56, 112),
                 num_points: int = 196):
        super().__init__()
        self.stage_num_classes = tuple(stage_num_classes)
        self._towers(num_convs_instance, num_convs_semantic,
                     conv_in_channels_instance, conv_in_channels_semantic,
                     conv_out_channels_instance, conv_out_channels_semantic)
        self.semantic_logits = nn.Conv2d(conv_out_channels_semantic, 1, 1)
        self.stages = nn.ModuleList()
        out_channel = conv_out_channels_instance
        for idx in range(len(stage_sup_size) - 1):
            in_channel = out_channel
            out_channel = in_channel // 2
            self.stages.append(PointSFMStage(
                conv_out_channels_semantic, in_channel, out_channel, num_fcs,
                stage_num_classes[idx], num_points, semantic_out_stride,
                mask_use_sigmoid, coarse_pred_each_layer))
        self.final_instance_logits = nn.Conv2d(out_channel,
                                               stage_num_classes[-1], 1)
        self.final_detail_logits = nn.Conv2d(out_channel,
                                             stage_num_classes[-1], 1)

    def forward(self, instance_feats, semantic_input, rois, roi_batch,
                roi_labels) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                                     torch.Tensor]:
        x, sem = self._run_towers(instance_feats, semantic_input)
        semantic_pred = self.semantic_logits(sem)
        insts, details = [], []
        for stage in self.stages:
            inst, det, x = stage(x, sem, rois, roi_batch, roi_labels)
            insts.append(inst)
            details.append(det)
        final = (torch.zeros_like(roi_labels)
                 if self.stage_num_classes[-1] == 1 else roi_labels)
        insts.append(_select(self.final_instance_logits(x), final))
        details.append(_select(self.final_detail_logits(x), final))
        return insts, details, semantic_pred


@HEADS.register_module()
class PointRefineRoIHead(RefineRoIHead):
    """``RefineRoIHead`` over a ``PointRefineMaskHead``: the mask head
    reads the 14x14 mask extract and P2; training adds, per stage, the
    instance BCE and ``detail_loss_weight`` times the detail BCE, each at
    the stage's weight, and the semantic BCE where the batch holds
    ``gt_semantic``; the test gives the last stage's 112x112
    probabilities."""

    with_semantic = True

    def __init__(self, bbox_head, mask_head: PointRefineMaskHead,
                 detail_loss_weight: float = 1.0, **kw):
        super().__init__(bbox_head, mask_head, **kw)
        self.detail_loss_weight = detail_loss_weight

    def _mask_forward_train(self, feats, sample, batch, gumbel_u=None,
                            generator=None):
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        insts, details, semantic_pred = self._mask_forward(
            feats, boxes, roi_batch, labels)
        v = valid.float()
        nv = v.sum().clamp(min=1.0)
        loss = 0.0
        for s, w, inst, det in zip(self.stage_sup_size,
                                   self.stage_instance_loss_weight, insts,
                                   details):
            target = mask_targets_from_crops(
                batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
                batch['img_shape'], s)
            bce = binary_cross_entropy_with_logits(inst[:, 0], target)
            loss = loss + w * (bce.mean((1, 2)) * v).sum() / nv
            dbce = binary_cross_entropy_with_logits(
                det[:, 0], detail_target(target, target.new_tensor(
                    [0.7, 0.3])))
            loss = loss + w * self.detail_loss_weight * (
                dbce.mean((1, 2)) * v).sum() / nv
        losses = {'loss_instance': loss}
        if 'gt_semantic' in batch:
            sp = semantic_pred[:, 0]
            target = batch['gt_semantic'].float()[:, :sp.shape[1],
                                                  :sp.shape[2]]
            losses['loss_semantic'] = self.semantic_loss_weight * \
                binary_cross_entropy_with_logits(sp, target).mean()
        return losses

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        insts, _, _ = self._mask_forward(feats, rois, roi_batch,
                                         labels.reshape(b * d))
        probs = torch.sigmoid(insts[-1][:, 0])
        return probs.reshape(b, d, *probs.shape[1:])
