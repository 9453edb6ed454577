"""Static-shape positive/negative sampling (port of ``RandomSampler`` and
``add_gt_as_proposals`` in ``dynamask_tpu/core/samplers.py``, :41-110 and
:345).

Every candidate gets a random priority; exactly ``num`` slots come out,
positives first (in priority order), then negatives, then invalid padding.
``num_expected_pos = round(num * pos_fraction)``; fewer positives leave the
rest of the budget to negatives. The JAX package draws the priorities from a
``jax.random`` key; here they come from an explicit ``torch.Generator``, or
are given as a tensor (the tests hand both sides the same draws).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .assigners import AssignResult

_BIG = 1e9


class SamplingResult(NamedTuple):
    inds: torch.Tensor          # (num,) int64 indices into the candidates
    is_pos: torch.Tensor        # (num,) bool
    valid: torch.Tensor         # (num,) bool, False for padded slots
    boxes: torch.Tensor         # (num, 4) the sampled candidate boxes
    gt_inds: torch.Tensor       # (num,) int64 assigned GT (0 where not pos)
    labels: torch.Tensor        # (num,) int64 class (-1 where not pos)
    target_boxes: torch.Tensor  # (num, 4) assigned GT boxes (0 where not)


def _rank(key: torch.Tensor) -> torch.Tensor:
    """Dense rank with ties broken by index (``argsort(argsort(key))``)."""
    return torch.argsort(torch.argsort(key, stable=True), stable=True)


class RandomSampler:
    def __init__(self, num: int, pos_fraction: float):
        self.num = num
        self.pos_fraction = pos_fraction

    def __call__(self, assign: AssignResult, boxes: torch.Tensor,
                 gt_boxes: torch.Tensor,
                 priorities: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> SamplingResult:
        """``boxes`` (N, 4) candidates, ``gt_boxes`` (K, 4); ``priorities``
        (N,) uniform draws, or drawn from ``generator``."""
        n = boxes.shape[0]
        r = priorities if priorities is not None else torch.rand(
            n, generator=generator, device=boxes.device)
        r = r.to(boxes.device, torch.float32)
        is_pos_cand = assign.gt_inds > 0
        is_neg_cand = assign.gt_inds == 0
        num_expected_pos = int(round(self.num * self.pos_fraction))
        pos_rank = _rank(torch.where(is_pos_cand, r, _BIG))
        sel_pos = is_pos_cand & (pos_rank < num_expected_pos)
        num_pos = sel_pos.sum()
        neg_rank = _rank(torch.where(is_neg_cand, r, _BIG))
        num_expected_neg = self.num - num_pos     # neg_pos_ub = -1
        sel_neg = is_neg_cand & (neg_rank < num_expected_neg)

        pack_key = torch.where(
            sel_pos, pos_rank.float(),
            torch.where(sel_neg, (self.num + neg_rank).float(), _BIG))
        inds = torch.argsort(pack_key, stable=True)[:self.num]
        valid = pack_key[inds] < _BIG
        is_pos = sel_pos[inds] & valid
        k = gt_boxes.shape[0]
        gt_inds = torch.where(is_pos,
                              (assign.gt_inds[inds] - 1).clamp(0, k - 1), 0)
        labels = torch.where(is_pos, assign.labels[inds], -1)
        target_boxes = torch.where(is_pos[:, None], gt_boxes[gt_inds], 0.0)
        return SamplingResult(inds, is_pos, valid, boxes[inds], gt_inds,
                              labels, target_boxes)


def add_gt_as_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """GT boxes put in front of the proposals: (boxes, validity)."""
    return (torch.cat([gt_boxes, proposals], 0),
            torch.cat([gt_valid.bool(), proposal_valid.bool()], 0))


def stack_samples(samples) -> SamplingResult:
    """Per-image results -> one result with a leading batch dimension."""
    return SamplingResult(*[torch.stack(f) for f in zip(*samples)])
