"""Static-shape exact greedy NMS and Soft-NMS (port of
``dynamask_tpu/ops/nms.py`` :30-260: ``nms``, ``soft_nms``,
``batched_nms``, ``multiclass_nms``; ``nms_match`` :262-305).

Candidates are capped at a static ``pre_top_k`` by score, greedy keep is
exact, and outputs fill fixed ``max_out`` slots with validity flags. This is
plain PyTorch on the device, not a hand kernel. The JAX package takes its
candidate cut with ``jax.lax.approx_max_k`` (``nms.py:107``), which is
approximate on a TPU but exact on CPU and GPU; the port uses the exact
``torch.topk``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.bbox_transforms import bbox_overlaps


def _greedy_keep(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_threshold: float, tile: int = 256) -> torch.Tensor:
    """Exact greedy keep mask over score-descending boxes, tile by tile.

    Each tile of ``tile`` boxes is first suppressed by the already-final
    kept boxes before it, then its internal chain is resolved by iterating
    ``a = alive & ~suppressed_by(a)`` to its fixed point, which is unique and
    equal to greedy NMS (box i depends only on boxes before it). The
    convergence test reads one flag back to the host per iteration."""
    k = boxes.shape[0]
    if k == 0:
        return valid.clone()
    tile = min(tile, k)
    keep = valid.clone()
    idx = torch.arange(k, device=boxes.device)
    tril = torch.tril(torch.ones(tile, tile, dtype=torch.bool,
                                 device=boxes.device), diagonal=-1)
    for s in range(0, k, tile):
        e = min(s + tile, k)
        iou_all = bbox_overlaps(boxes[s:e], boxes)          # (t, k)
        prev_kept = keep & (idx < s)
        alive = valid[s:e] & ~((iou_all > iou_threshold) &
                               prev_kept[None, :]).any(1)
        sup = (iou_all[:, s:e] > iou_threshold) & tril[:e - s, :e - s]
        a = alive
        for _ in range(e - s):
            nxt = alive & ~(sup & a[None, :]).any(1)
            if torch.equal(nxt, a):
                break
            a = nxt
        keep[s:e] = a
    return keep


def nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
        iou_threshold: float, max_out: int, pre_top_k: int = 4096
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS with static shapes.

    Returns (boxes (max_out, 4), scores (max_out,), keep_inds (max_out,)
    int64 into the input, valid (max_out,) bool), score-sorted; padded slots
    carry zeros and ``valid`` False."""
    n = boxes.shape[0]
    k = min(pre_top_k, n)
    neg_inf = float('-inf')
    masked = torch.where(valid, scores, torch.full_like(scores, neg_inf))
    top_scores, top_idx = torch.topk(masked, k)
    top_boxes = boxes[top_idx]
    keep = _greedy_keep(top_boxes, top_scores > neg_inf, iou_threshold)
    kept_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, neg_inf))
    out_scores, pos = torch.topk(kept_scores, min(max_out, k))
    if max_out > k:
        pad = max_out - k
        out_scores = torch.cat([out_scores,
                                out_scores.new_full((pad,), neg_inf)])
        pos = torch.cat([pos, pos.new_zeros(pad)])
    out_valid = out_scores > neg_inf
    out_boxes = torch.where(out_valid[:, None], top_boxes[pos],
                            torch.zeros_like(top_boxes[pos]))
    out_inds = torch.where(out_valid, top_idx[pos], torch.zeros_like(pos))
    out_scores = torch.where(out_valid, out_scores,
                             torch.zeros_like(out_scores))
    return out_boxes, out_scores, out_inds, out_valid


def soft_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.3, sigma: float = 0.5,
             min_score: float = 1e-3, method: str = 'linear',
             max_out: int = 100, pre_top_k: int = 1024):
    """Soft-NMS with static shapes (JAX ``nms.py:131-181``): exactly
    ``max_out`` selection steps on the device, none read back to the
    host. Each takes the highest live score and decays the others by its
    IoU with them: ``linear`` by (1 - IoU) past ``iou_threshold``,
    ``gaussian`` by exp(-IoU²/sigma); the taken box and those decayed
    below ``min_score`` leave the pool. Returns (boxes (max_out, 4),
    scores, keep_inds into the input, valid = score > 0)."""
    if method not in ('linear', 'gaussian'):
        raise NotImplementedError(f'soft_nms method {method!r}')
    n = boxes.shape[0]
    k = min(pre_top_k, n)
    neg_inf = float('-inf')
    masked = torch.where(valid, scores.float(),
                         torch.full_like(scores, neg_inf, dtype=torch.float))
    cur, top_idx = torch.topk(masked, k)
    top_boxes = boxes[top_idx]
    iou = bbox_overlaps(top_boxes, top_boxes)                  # (k, k)
    if method == 'gaussian':
        decay = torch.exp(-(iou * iou) / sigma)
    else:
        decay = torch.where(iou > iou_threshold, 1.0 - iou,
                            torch.ones_like(iou))
    out_scores = cur.new_full((max_out,), neg_inf)
    out_pos = torch.zeros(max_out, dtype=torch.long, device=boxes.device)
    for i in range(max_out):      # one-element index tensors: no host sync
        best = torch.argmax(cur).reshape(1)
        out_scores[i:i + 1] = cur.index_select(0, best)
        out_pos[i:i + 1] = best
        cur = (cur * decay.index_select(0, best)[0]).index_fill_(0, best,
                                                                 neg_inf)
        cur = torch.where(cur < min_score, neg_inf, cur)
    out_valid = out_scores > 0.0
    out_boxes = torch.where(out_valid[:, None], top_boxes[out_pos],
                            torch.zeros_like(top_boxes[out_pos]))
    out_inds = torch.where(out_valid, top_idx[out_pos],
                           torch.zeros_like(out_pos))
    out_scores = torch.where(out_valid, out_scores,
                             torch.zeros_like(out_scores))
    return out_boxes, out_scores, out_inds, out_valid


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                idxs: torch.Tensor, valid: torch.Tensor,
                iou_threshold: float, max_out: int, pre_top_k: int = 4096):
    """Category/level-aware NMS by the coordinate-offset trick: boxes of
    different ``idxs`` never suppress each other."""
    max_coord = torch.where(valid[:, None], boxes,
                            torch.zeros_like(boxes)).max() + 1.0
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord)[:, None]
    _, out_scores, out_inds, out_valid = nms(
        shifted, scores, valid, iou_threshold, max_out, pre_top_k)
    out_boxes = torch.where(out_valid[:, None], boxes[out_inds],
                            torch.zeros_like(boxes[out_inds]))
    return out_boxes, out_scores, out_inds, out_valid


def multiclass_nms(multi_bboxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float, iou_threshold: float, max_per_img: int,
                   valid: Optional[torch.Tensor] = None,
                   pre_top_k: int = 2048, nms_type: str = 'nms',
                   sigma: float = 0.5, min_score: float = 1e-3):
    """Per-class NMS over dense (N, C) foreground scores: greedy, or with
    ``nms_type='soft_nms'`` linear Soft-NMS (``sigma``, ``min_score``)
    over the class-offset boxes (JAX ``nms.py:242-252``).

    ``multi_bboxes`` is (N, 4) or (N, C*4). Returns dets (max_per_img, 5)
    ``[x1, y1, x2, y2, score]``, labels (max_per_img,) int64 and validity."""
    n, num_classes = multi_scores.shape
    if multi_bboxes.shape[-1] == 4:
        boxes = multi_bboxes[:, None, :].expand(n, num_classes, 4)
    else:
        boxes = multi_bboxes.reshape(n, num_classes, 4)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=multi_scores.device)
    flat_boxes = boxes.reshape(-1, 4)
    flat_scores = multi_scores.reshape(-1)
    flat_labels = torch.arange(num_classes,
                               device=multi_scores.device).repeat(n)
    flat_valid = valid.repeat_interleave(num_classes) & \
        (flat_scores > score_thr)
    if nms_type == 'soft_nms':
        max_coord = torch.where(flat_valid[:, None], flat_boxes,
                                torch.zeros_like(flat_boxes)).max() + 1.0
        shifted = flat_boxes + (flat_labels.to(flat_boxes.dtype) *
                                max_coord)[:, None]
        _, out_scores, out_inds, out_valid = soft_nms(
            shifted, flat_scores, flat_valid, iou_threshold, sigma,
            min_score, max_out=max_per_img, pre_top_k=pre_top_k)
        out_boxes = torch.where(out_valid[:, None], flat_boxes[out_inds],
                                torch.zeros_like(flat_boxes[out_inds]))
    elif nms_type == 'nms':
        out_boxes, out_scores, out_inds, out_valid = batched_nms(
            flat_boxes, flat_scores, flat_labels, flat_valid, iou_threshold,
            max_per_img, pre_top_k)
    else:
        raise NotImplementedError(f'multiclass_nms nms_type {nms_type!r}')
    out_labels = torch.where(out_valid, flat_labels[out_inds],
                             torch.zeros_like(out_inds))
    dets = torch.cat([out_boxes, out_scores[:, None]], dim=1)
    return dets, out_labels, out_valid


def nms_match(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
              iou_threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS *matching* (port of ``nms_match``,
    ``dynamask_tpu/ops/nms.py:262-305``): each box's group leader, the
    kept box that suppresses it (the first kept box in score order whose
    IoU with it is over ``iou_threshold``), and its 0-based score rank
    within that group, ties in input order. -> (leader (N,) int64 index
    into the input, -1 for an invalid box or one no kept box matches;
    rank (N,) int64)."""
    n = boxes.shape[0]
    order = torch.argsort(torch.where(valid, -scores, float('inf')),
                          stable=True)
    sb, sv = boxes[order], valid[order]
    keep = _greedy_keep(sb, sv, iou_threshold)
    j = torch.arange(n, device=boxes.device)
    match = (keep[:, None] & (bbox_overlaps(sb, sb) > iou_threshold) &
             sv[None, :] & (j[:, None] <= j[None, :]))
    leader = (match.long() * (n - j)[:, None]).argmax(0)
    has = match.any(0) & sv
    same = has[:, None] & has[None, :] & (leader[:, None] == leader[None])
    rank = (same & (j[:, None] < j[None, :])).sum(0)
    inv = torch.argsort(order)
    leader = torch.where(has, order[leader], -1)
    return leader[inv], rank[inv]
