"""RPN head, its training loss and static-shape proposals (port of
``dynamask_tpu/models/rpn_head.py``: ``RPNHead``, ``rpn_loss`` :85-153 and
``rpn_get_proposals`` :155-218)."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.assigners import MaxIoUAssigner
from ..core.bbox_transforms import bbox2delta, clip_boxes, delta2bbox
from ..core.samplers import RandomSampler
from ..ops.nms import batched_nms
from ..utils.registry import HEADS
from .losses import binary_cross_entropy_with_logits, smooth_l1_elementwise


class Proposals(NamedTuple):
    boxes: torch.Tensor   # (B, max_num, 4)
    scores: torch.Tensor  # (B, max_num)
    valid: torch.Tensor   # (B, max_num) bool


@HEADS.register_module()
class RPNHead(nn.Module):
    """3×3 shared conv + 1×1 objectness / box-delta convs."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3):
        super().__init__()
        self.num_anchors = num_anchors
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW levels -> per-level (B, A, H, W) scores, (B, 4A, H, W)
        deltas."""
        cls_scores, bbox_preds = [], []
        for x in feats:
            t = F.relu(self.rpn_conv(x))
            cls_scores.append(self.rpn_cls(t))
            bbox_preds.append(self.rpn_reg(t))
        return cls_scores, bbox_preds


def _flatten_levels(cls_scores, bbox_preds):
    """Per-level (B, A, H, W) / (B, 4A, H, W) maps -> (B, K) scores and
    (B, K, 4) deltas, location-major and anchor-minor like the anchors."""
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([c.permute(0, 2, 3, 1).reshape(b, -1)
                          for c in cls_scores], 1)
    flat_reg = torch.cat([r.permute(0, 2, 3, 1).reshape(b, -1, 4)
                          for r in bbox_preds], 1)
    return flat_cls, flat_reg


def rpn_loss(cls_scores: List[torch.Tensor], bbox_preds: List[torch.Tensor],
             anchors: torch.Tensor, anchor_valid: torch.Tensor,
             gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
             assigner: MaxIoUAssigner, sampler: RandomSampler,
             target_means=(0., 0., 0., 0.), target_stds=(1., 1., 1., 1.),
             loss_cls_weight: float = 1.0, loss_bbox_weight: float = 1.0,
             priorities: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             smoothl1_beta: Optional[float] = None):
    """Sigmoid BCE over the sampled anchors and L1 (SmoothL1 of
    ``smoothl1_beta``, GA-RPN's) over the positive ones, both divided by
    the batch's total sampled count. ``anchors`` (K, 4), or (B, K, 4) an
    image's own (GA-RPN's guided anchors), ``anchor_valid`` (B, K);
    ``priorities`` (B, K) sampler draws, else drawn from ``generator``."""
    flat_cls, flat_reg = _flatten_levels(cls_scores, bbox_preds)
    b, k = flat_cls.shape
    anchors = anchors.expand(b, -1, -1)       # (B, K, 4): a view
    cls_sum = reg_sum = count = 0.0
    for i in range(b):
        anc = anchors[i]
        assign = assigner(anc, anchor_valid[i], gt_boxes[i], gt_valid[i])
        sample = sampler(assign, anc, gt_boxes[i],
                         None if priorities is None else priorities[i],
                         generator)
        pos = (sample.is_pos & sample.valid).float()
        w = torch.zeros(k, device=anc.device).index_add(
            0, sample.inds, sample.valid.float())
        target = torch.zeros(k, device=anc.device).index_add(
            0, sample.inds, pos)
        deltas = bbox2delta(sample.boxes, sample.target_boxes, target_means,
                            target_stds)
        reg_t = torch.zeros_like(anc).index_add(
            0, sample.inds, deltas * pos[:, None])
        cls_sum = cls_sum + (binary_cross_entropy_with_logits(
            flat_cls[i], target) * w).sum()
        reg_l = ((flat_reg[i] - reg_t).abs() if smoothl1_beta is None else
                 smooth_l1_elementwise(flat_reg[i], reg_t, smoothl1_beta))
        reg_sum = reg_sum + (reg_l * target[:, None]).sum()
        count = count + w.sum()
    avg = count.clamp(min=1.0)
    return {'loss_rpn_cls': loss_cls_weight * cls_sum / avg,
            'loss_rpn_bbox': loss_bbox_weight * reg_sum / avg}


def rpn_get_proposals(cls_scores: List[torch.Tensor],
                      bbox_preds: List[torch.Tensor],
                      mlvl_anchors: List[torch.Tensor],
                      img_shapes: torch.Tensor,
                      nms_pre: int = 2000, max_num: int = 1000,
                      nms_thr: float = 0.7,
                      target_means=(0., 0., 0., 0.),
                      target_stds=(1., 1., 1., 1.),
                      pre_top_k: int = 3072) -> Proposals:
    """Per-level sigmoid scores -> top ``nms_pre`` -> decode and clip ->
    level-aware NMS -> ``max_num`` slots. Scores and deltas are NCHW conv
    maps; they are read location-major, anchor-minor (the anchor layout).
    A level's anchors are (A, 4), or (B, A, 4) each image's own."""
    b = cls_scores[0].shape[0]
    lvl_boxes, lvl_scores, lvl_ids = [], [], []
    for lvl, (cs, bp, anc) in enumerate(zip(cls_scores, bbox_preds,
                                            mlvl_anchors)):
        scores = torch.sigmoid(cs.float().permute(0, 2, 3, 1).reshape(b, -1))
        k = min(nms_pre, scores.shape[1])
        top_s, top_i = torch.topk(scores, k, dim=1)
        deltas = bp.float().permute(0, 2, 3, 1).reshape(b, -1, 4)  # (B, HWA, 4)
        top_d = torch.gather(deltas, 1, top_i[..., None].expand(b, k, 4))
        top_a = torch.gather(anc.expand(b, -1, -1), 1,
                             top_i[..., None].expand(b, k, 4))
        boxes = delta2bbox(top_a, top_d, target_means, target_stds)
        boxes = clip_boxes(boxes, img_shapes[:, None, :])
        lvl_boxes.append(boxes)
        lvl_scores.append(top_s)
        lvl_ids.append(torch.full((b, k), lvl, dtype=torch.int64,
                                  device=scores.device))
    all_boxes = torch.cat(lvl_boxes, 1)
    all_scores = torch.cat(lvl_scores, 1)
    all_ids = torch.cat(lvl_ids, 1)
    outs = [batched_nms(all_boxes[i], all_scores[i], all_ids[i],
                        all_scores[i] > 0, nms_thr, max_num, pre_top_k)
            for i in range(b)]
    return Proposals(torch.stack([o[0] for o in outs]),
                     torch.stack([o[1] for o in outs]),
                     torch.stack([o[3] for o in outs]))
