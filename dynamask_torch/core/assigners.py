"""Static-shape max-IoU assignment (port of ``MaxIoUAssigner`` in
``dynamask_tpu/core/assigners.py:39-178``, the form the flagship uses: no
ignore regions).

Every candidate box and every GT slot carries a validity flag; the
assignment is dense over the fixed (num_gts, num_boxes) overlap matrix.
Encoding as the reference's: -1 ignore, 0 negative, k > 0 GT k - 1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .bbox_transforms import bbox_overlaps


class AssignResult(NamedTuple):
    gt_inds: torch.Tensor       # (N,) int64, -1 / 0 / k
    max_overlaps: torch.Tensor  # (N,) float32
    labels: torch.Tensor        # (N,) int64, -1 where not assigned


class MaxIoUAssigner:
    """1. default -1; 2. max IoU < neg_thr -> 0; 3. max IoU >= pos_thr ->
    best GT; 4. (``match_low_quality``) each valid GT claims all the boxes
    tying its best overlap if that overlap >= ``min_pos_iou``, the last GT
    winning (the reference's ``gt_max_assign_all=True``, the only form the
    configs use)."""

    def __init__(self, pos_iou_thr: float, neg_iou_thr: float,
                 min_pos_iou: float = 0.0, match_low_quality: bool = True):
        self.pos_iou_thr = pos_iou_thr
        self.neg_iou_thr = neg_iou_thr
        self.min_pos_iou = min_pos_iou
        self.match_low_quality = match_low_quality

    def __call__(self, boxes: torch.Tensor, box_valid: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 gt_labels: Optional[torch.Tensor] = None) -> AssignResult:
        """``boxes`` (N, 4) with ``box_valid`` (N,); ``gt_boxes`` (K, 4)
        with ``gt_valid`` (K,); optional ``gt_labels`` (K,)."""
        box_valid = box_valid.bool()
        gt_valid = gt_valid.bool()
        overlaps = bbox_overlaps(gt_boxes, boxes)               # (K, N)
        overlaps = torch.where(gt_valid[:, None] & box_valid[None, :],
                               overlaps, -1.0)
        return self.assign_wrt_overlaps(overlaps, gt_valid, box_valid,
                                        gt_labels)

    def assign_wrt_overlaps(self, overlaps: torch.Tensor,
                            gt_valid: torch.Tensor, box_valid: torch.Tensor,
                            gt_labels: Optional[torch.Tensor] = None
                            ) -> AssignResult:
        """Steps 1-4 on a (K, N) overlap matrix whose invalid rows and
        columns are already -1 (JAX ``assign_wrt_overlaps``, the entry of
        guided anchoring's approx-max overlaps)."""
        num_gts = overlaps.shape[0]
        box_valid = box_valid.bool()
        gt_valid = gt_valid.bool()

        # argmax takes the first of tied maxima, as jnp.argmax does
        max_overlaps = overlaps.max(0).values
        argmax = overlaps.argmax(0)
        gt_max = overlaps.max(1).values
        assigned = torch.full((overlaps.shape[1],), -1, dtype=torch.int64,
                              device=overlaps.device)
        neg = (max_overlaps >= 0) & (max_overlaps < self.neg_iou_thr)
        assigned = torch.where(neg, 0, assigned)
        assigned = torch.where(max_overlaps >= self.pos_iou_thr, argmax + 1,
                               assigned)
        if self.match_low_quality:
            claim = ((gt_valid & (gt_max >= self.min_pos_iou))[:, None] &
                     (overlaps == gt_max[:, None]) & (overlaps > -1))
            ids = torch.arange(num_gts, device=overlaps.device)[:, None]
            last = torch.where(claim, ids, -1).max(0).values
            assigned = torch.where(last >= 0, last + 1, assigned)
        assigned = torch.where(gt_valid.any(), assigned,
                               torch.zeros_like(assigned))
        assigned = torch.where(box_valid, assigned, -1)
        max_overlaps = torch.where(box_valid, max_overlaps.clamp(min=0.0),
                                   0.0)
        if gt_labels is not None:
            safe = (assigned - 1).clamp(0, num_gts - 1)
            labels = torch.where(assigned > 0, gt_labels.long()[safe], -1)
        else:
            labels = torch.full_like(assigned, -1)
        return AssignResult(assigned, max_overlaps, labels)


class ATSSAssigner:
    """Adaptive training sample selection (port of ``ATSSAssigner``,
    ``dynamask_tpu/core/assigners.py:188-260``): per GT the ``topk``
    anchors of each level whose centres lie closest to its centre are the
    candidates; the positive threshold is the candidates' IoU mean plus
    their standard deviation, the biased one as JAX takes it (mmdet's
    ``Tensor.std`` is the unbiased one: ROADMAP.md queue 3, 3ac); a
    positive's centre lies strictly inside its GT; an anchor claimed by
    several GTs takes the one of highest IoU (the first of ties)."""

    def __init__(self, topk: int = 9):
        self.topk = topk

    def __call__(self, boxes: torch.Tensor, box_valid: torch.Tensor,
                 gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                 gt_labels: Optional[torch.Tensor] = None,
                 num_level_anchors=None) -> AssignResult:
        num_gts, n = gt_boxes.shape[0], boxes.shape[0]
        box_valid = box_valid.bool()
        gt_valid = gt_valid.bool()
        num_level_anchors = num_level_anchors or (n,)
        overlaps = bbox_overlaps(gt_boxes, boxes)                # (K, N)
        overlaps = torch.where(gt_valid[:, None] & box_valid[None, :],
                               overlaps, 0.0)
        acx = (boxes[:, 0] + boxes[:, 2]) * 0.5
        acy = (boxes[:, 1] + boxes[:, 3]) * 0.5
        gcx = (gt_boxes[:, 0] + gt_boxes[:, 2]) * 0.5
        gcy = (gt_boxes[:, 1] + gt_boxes[:, 3]) * 0.5
        dist = torch.sqrt((acx[None, :] - gcx[:, None]) ** 2 +
                          (acy[None, :] - gcy[:, None]) ** 2)
        dist = torch.where(box_valid[None, :], dist, float('inf'))
        # the k nearest of each level; a stable sort takes the lower index
        # of tied distances first, as ``jax.lax.top_k`` does
        candidate = torch.zeros_like(dist, dtype=torch.bool)
        start = 0
        for n_lvl in num_level_anchors:
            k = min(self.topk, n_lvl)
            idx = torch.sort(dist[:, start:start + n_lvl], dim=1,
                             stable=True).indices[:, :k]
            candidate[:, start:start + n_lvl].scatter_(1, idx, True)
            start += n_lvl
        count = candidate.sum(1, keepdim=True).clamp(min=1)
        cand_iou = torch.where(candidate, overlaps, 0.0)
        mean = cand_iou.sum(1, keepdim=True) / count
        dev = torch.where(candidate, (overlaps - mean) ** 2, 0.0)
        thr = mean + torch.sqrt(dev.sum(1, keepdim=True) / count)
        inside = ((acx[None, :] > gt_boxes[:, 0:1]) &
                  (acx[None, :] < gt_boxes[:, 2:3]) &
                  (acy[None, :] > gt_boxes[:, 1:2]) &
                  (acy[None, :] < gt_boxes[:, 3:4]))
        pos = candidate & (overlaps >= thr) & inside & gt_valid[:, None]
        claimed = torch.where(pos, overlaps, -1.0)
        best, best_gt = claimed.max(0).values, claimed.argmax(0)
        assigned = torch.where(best > -1.0, best_gt + 1, 0)
        assigned = torch.where(box_valid, assigned, -1)
        max_overlaps = torch.where(gt_valid[:, None], overlaps, 0.0).max(
            0).values
        if gt_labels is not None:
            safe = (assigned - 1).clamp(0, num_gts - 1)
            labels = torch.where(assigned > 0, gt_labels.long()[safe], -1)
        else:
            labels = torch.full_like(assigned, -1)
        return AssignResult(assigned, max_overlaps, labels)
