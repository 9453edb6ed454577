"""Static-shape positive/negative sampling (port of ``RandomSampler``, its
``neg_pos_ub``, Libra R-CNN's ``InstanceBalancedPosSampler``,
``IoUBalancedNegSampler`` and ``CombinedSampler``, and
``add_gt_as_proposals`` in ``dynamask_tpu/core/samplers.py``, :41-230,
:265-297 and :345).

Every candidate gets a random priority; exactly ``num`` slots come out,
positives first (in priority order), then negatives, then invalid padding.
``num_expected_pos = round(num * pos_fraction)``; fewer positives leave the
rest of the budget to negatives. The JAX package draws the priorities from a
``jax.random`` key; here they come from an explicit ``torch.Generator``, or
are given (the tests hand both sides the same draws): a tensor, the
sampler's own draw, or a dict of named draws, '' the sampler's own and
``'n'`` the one ``InstanceBalancedPosSampler`` takes for its negatives
(JAX's ``fold_in(key, 1)``); ``CombinedSampler`` hands its positive and
negative samplers the draws named ``pos[_...]`` and ``neg[_...]`` (JAX's
``fold_in(key, 101)`` and ``fold_in(key, 202)``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

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


Draws = Union[None, torch.Tensor, Dict[str, torch.Tensor]]


def draw(priorities: Draws, name: str, n: int, device,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The (n,) uniform draw ``name`` of ``priorities`` (a tensor is the
    draw named ''), or one from ``generator`` where it holds none."""
    if not isinstance(priorities, dict):
        priorities = {'': priorities}
    r = priorities.get(name)
    if r is None:
        r = torch.rand(n, generator=generator, device=device)
    return r.to(device, torch.float32)


def sub_draws(priorities: Draws, prefix: str) -> Dict[str, torch.Tensor]:
    """The draws of ``priorities`` named ``prefix`` or ``prefix_<name>``,
    renamed '' and ``<name>``."""
    if not isinstance(priorities, dict):
        return {}
    return {('' if k == prefix else k[len(prefix) + 1:]): v
            for k, v in priorities.items()
            if k == prefix or k.startswith(prefix + '_')}


def pack(assign: AssignResult, boxes: torch.Tensor, gt_boxes: torch.Tensor,
         sel_pos: torch.Tensor, pos_rank: torch.Tensor, sel_neg: torch.Tensor,
         neg_rank: torch.Tensor, num: int) -> SamplingResult:
    """``num`` slots: the selected positives in ``pos_rank`` order, then the
    selected negatives in ``neg_rank`` order, then invalid padding."""
    pack_key = torch.where(
        sel_pos, pos_rank.float(),
        torch.where(sel_neg, (num + neg_rank).float(), _BIG))
    inds = torch.argsort(pack_key, stable=True)[:num]
    valid = pack_key[inds] < _BIG
    is_pos = sel_pos[inds] & valid
    k = gt_boxes.shape[0]
    gt_inds = torch.where(is_pos, (assign.gt_inds[inds] - 1).clamp(0, k - 1),
                          0)
    labels = torch.where(is_pos, assign.labels[inds], -1)
    target_boxes = torch.where(is_pos[:, None], gt_boxes[gt_inds], 0.0)
    return SamplingResult(inds, is_pos, valid, boxes[inds], gt_inds, labels,
                          target_boxes)


class RandomSampler:
    """Uniform priorities; at most ``max(1, neg_pos_ub * num_pos)``
    negatives where ``neg_pos_ub >= 0``."""

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1):
        self.num = num
        self.pos_fraction = pos_fraction
        self.neg_pos_ub = neg_pos_ub

    @property
    def num_expected_pos(self) -> int:
        return int(round(self.num * self.pos_fraction))

    def num_expected_neg(self, num_pos: torch.Tensor) -> torch.Tensor:
        """The negatives' budget beside ``num_pos`` positives."""
        if self.neg_pos_ub < 0:
            return self.num - num_pos
        return torch.minimum(self.num - num_pos,
                             (self.neg_pos_ub * num_pos).clamp(min=1))

    def __call__(self, assign: AssignResult, boxes: torch.Tensor,
                 gt_boxes: torch.Tensor, priorities: Draws = None,
                 generator: Optional[torch.Generator] = None
                 ) -> SamplingResult:
        """``boxes`` (N, 4) candidates, ``gt_boxes`` (K, 4); ``priorities``
        the (N,) uniform draws (see the module docstring), else drawn from
        ``generator``."""
        r = draw(priorities, '', boxes.shape[0], boxes.device, generator)
        is_pos_cand = assign.gt_inds > 0
        is_neg_cand = assign.gt_inds == 0
        pos_rank = _rank(torch.where(is_pos_cand, r, _BIG))
        sel_pos = is_pos_cand & (pos_rank < self.num_expected_pos)
        num_pos = sel_pos.sum()
        neg_rank = _rank(torch.where(is_neg_cand, r, _BIG))
        sel_neg = is_neg_cand & (neg_rank < self.num_expected_neg(num_pos))
        return pack(assign, boxes, gt_boxes, sel_pos, pos_rank, sel_neg,
                    neg_rank, self.num)


def _segment_rank(keys: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Each slot's position within its run of equal ``keys[order]``, laid
    out in ``order`` (JAX's associative-scan segment starts)."""
    n = keys.shape[0]
    ks = keys[order]
    idx = torch.arange(n, device=keys.device)
    same = torch.cat([ks.new_zeros(1, dtype=torch.bool), ks[1:] == ks[:-1]])
    start = torch.cummax(torch.where(same, 0, idx), 0).values
    return idx - start


class InstanceBalancedPosSampler(RandomSampler):
    """Positives spread over the GT instances: ranked round-robin by their
    rank within their GT (then half a draw); negatives from a second draw
    ('n'), at most ``num - num_pos`` (no ``neg_pos_ub``, as in JAX)."""

    def __call__(self, assign, boxes, gt_boxes, priorities: Draws = None,
                 generator=None) -> SamplingResult:
        n, dev = boxes.shape[0], boxes.device
        is_pos = assign.gt_inds > 0
        r = draw(priorities, '', n, dev, generator)
        group = torch.where(is_pos, assign.gt_inds, -1)
        by_r = torch.argsort(r, stable=True)
        order = by_r[torch.argsort(group[by_r], stable=True)]
        ranked = torch.empty_like(order)
        ranked[order] = _segment_rank(group, order)
        prio = torch.where(is_pos, ranked.float() + r * 0.5, _BIG)
        pos_rank = _rank(prio)
        sel_pos = is_pos & (pos_rank < self.num_expected_pos)
        is_neg = assign.gt_inds == 0
        r2 = draw(priorities, 'n', n, dev, generator)
        neg_rank = _rank(torch.where(is_neg, r2, _BIG))
        sel_neg = is_neg & (neg_rank < self.num - sel_pos.sum())
        return pack(assign, boxes, gt_boxes, sel_pos, pos_rank, sel_neg,
                    neg_rank, self.num)


class IoUBalancedNegSampler(RandomSampler):
    """Negatives stratified over ``num_bins`` IoU bands, as JAX draws them:
    the bands split ``[max(floor_thr, 0), max(the negatives' largest IoU,
    1e-3)]`` evenly, and negatives go round-robin over the bands in draw
    order; positives by the same draw, at most ``num - num_pos``
    negatives (no ``neg_pos_ub``, no ``floor_fraction``)."""

    def __init__(self, num: int, pos_fraction: float, floor_thr: float = -1,
                 num_bins: int = 3, neg_pos_ub: int = -1):
        super().__init__(num, pos_fraction, neg_pos_ub)
        self.floor_thr = floor_thr
        self.num_bins = num_bins

    def __call__(self, assign, boxes, gt_boxes, priorities: Draws = None,
                 generator=None) -> SamplingResult:
        n, dev = boxes.shape[0], boxes.device
        is_neg = assign.gt_inds == 0
        iou = assign.max_overlaps
        lo = max(self.floor_thr, 0.0)
        hi = torch.where(is_neg, iou, 0.0).max().clamp(min=1e-3)
        band = ((iou - lo) / (hi - lo) * self.num_bins).to(
            torch.int32).clamp(0, self.num_bins - 1)
        r = draw(priorities, '', n, dev, generator)
        key = band.float() * 1e4 + r
        order = torch.argsort(torch.where(is_neg, key, _BIG), stable=True)
        within = torch.empty_like(order)
        within[order] = _segment_rank(band, order)
        neg_prio = torch.where(is_neg, within.float() * self.num_bins +
                               band.float(), _BIG)
        is_pos = assign.gt_inds > 0
        pos_rank = _rank(torch.where(is_pos, r, _BIG))
        sel_pos = is_pos & (pos_rank < self.num_expected_pos)
        neg_rank = _rank(neg_prio)
        sel_neg = is_neg & (neg_rank < self.num - sel_pos.sum())
        return pack(assign, boxes, gt_boxes, sel_pos, pos_rank, sel_neg,
                    neg_rank, self.num)


class CombinedSampler(RandomSampler):
    """A positive sampler's positive slots and a negative sampler's others:
    both pack the same number of positives first, so the slot counts
    line up. Its draws: the positive sampler's ``pos[_...]``, the negative
    sampler's ``neg[_...]``."""

    def __init__(self, num: int, pos_fraction: float,
                 pos_sampler: RandomSampler, neg_sampler: RandomSampler,
                 neg_pos_ub: int = -1):
        super().__init__(num, pos_fraction, neg_pos_ub)
        self.pos_sampler = pos_sampler
        self.neg_sampler = neg_sampler

    def __call__(self, assign, boxes, gt_boxes, priorities: Draws = None,
                 generator=None) -> SamplingResult:
        rp = self.pos_sampler(assign, boxes, gt_boxes,
                              sub_draws(priorities, 'pos'), generator)
        rn = self.neg_sampler(assign, boxes, gt_boxes,
                              sub_draws(priorities, 'neg'), generator)
        pick = rp.is_pos
        return SamplingResult(*(torch.where(
            pick.reshape(pick.shape + (1,) * (a.dim() - 1)), a, b)
            for a, b in zip(rp, rn)))


def add_gt_as_proposals(proposals: torch.Tensor, proposal_valid: torch.Tensor,
                        gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """GT boxes put in front of the proposals: (boxes, validity)."""
    return (torch.cat([gt_boxes, proposals], 0),
            torch.cat([gt_valid.bool(), proposal_valid.bool()], 0))


def stack_samples(samples) -> SamplingResult:
    """Per-image results -> one result with a leading batch dimension."""
    return SamplingResult(*[torch.stack(f) for f in zip(*samples)])
