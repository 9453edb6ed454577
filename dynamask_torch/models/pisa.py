"""PISA, prime sample attention (port of ``dynamask_tpu/models/pisa.py``):
ISR-P, the positives' importance reweighting by their IoU hierarchical
local rank (``isr_p_label_weights`` :97-160, over a dense anchor set
``isr_p_dense`` :482-508); CARL, the classification-aware regression loss
(``carl_loss`` :167-206); ISR-N, the negatives' Score-HLR sampling and
weights (``ScoreHLRSampler`` :209-343); ``PISARoIHead`` (:350-475) and the
single-stage ``PISASSD`` and ``PISARetinaNet`` (:513-685).

Every candidate keeps its slot; ranks and groups are dense masked
comparisons, O(N^2) over the N candidates, with JAX's tie rules (a tie
goes to the lower index). The reweighting reads the predictions without
their gradient (JAX's ``stop_gradient``); CARL keeps the classifier's.

``PISARoIHead`` runs one box forward over every candidate of the batch
(each image's GTs in front of its proposals) without a gradient to score
the negatives: one K2 launch and no K4, as JAX's ``stop_gradient`` drops
that VJP; then the head's usual box forward on the sampled slots (K2, K4
in the backward) and the mask branch's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.bbox_transforms import delta2bbox
from ..core.samplers import (_BIG, Draws, RandomSampler, SamplingResult,
                             _rank, add_gt_as_proposals, draw, pack,
                             stack_samples)
from ..ops.nms import nms_match
from ..utils.registry import DETECTORS
from .bbox_head import BBoxTargets, bbox_targets_from_sample
from .losses import (accuracy, focal_elementwise, smooth_l1_elementwise,
                     softmax_cross_entropy)
from .roi_head import StandardRoIHead, image_draws, sampler_draws
from .single_stage import SingleStageDetector, flatten_levels, one_hot_fg
from .ssd import SSD


def ce_elementwise(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """Each row's cross entropy against its label."""
    return -F.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]


def aligned_iou(a: torch.Tensor, b: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """The IoU of each row of (N, 4) ``a`` with the same row of ``b``."""
    lt = torch.maximum(a[:, :2], b[:, :2])
    rb = torch.minimum(a[:, 2:], b[:, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[:, 0] * wh[:, 1]
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0.0) * \
        (a[:, 3] - a[:, 1]).clamp(min=0.0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0.0) * \
        (b[:, 3] - b[:, 1]).clamp(min=0.0)
    return inter / (area_a + area_b - inter).clamp(min=eps)


def rank_desc_within(values: torch.Tensor, same: Optional[torch.Tensor],
                     member: torch.Tensor) -> torch.Tensor:
    """Each slot's 0-based descending rank of ``values`` within its group
    (``same[i, j]``: i and j in one group; None: one group) among the
    ``member`` slots, a tie to the lower index."""
    idx = torch.arange(values.shape[0], device=values.device)
    before = member[None, :] & member[:, None] & (
        (values[None, :] > values[:, None]) |
        ((values[None, :] == values[:, None]) &
         (idx[None, :] < idx[:, None])))
    if same is not None:
        before = before & same
    return before.sum(1)


def _class_deltas(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N, 4) deltas: each row's ``labels`` class of (N, C * 4) ``preds``,
    or ``preds`` when they are (N, 4)."""
    if preds.shape[-1] == 4:
        return preds
    n = preds.shape[0]
    return preds.reshape(n, -1, 4)[torch.arange(n, device=preds.device),
                                   labels]


@torch.no_grad()
def isr_p_label_weights(cls_scores: torch.Tensor, bbox_preds: torch.Tensor,
                        targets: BBoxTargets, rois: torch.Tensor,
                        group_ids: torch.Tensor, num_classes: int,
                        target_means, target_stds,
                        pos_loss_fn: Optional[Callable] = None,
                        k: float = 2.0, bias: float = 0.0) -> torch.Tensor:
    """ISR-P: the positives' label weights by IoU-HLR over the batch-flat
    slots (``group_ids`` unique per image and GT): each positive's decoded
    box's IoU with its target, ranked within its (class, GT) group, then
    ``max_l_num - rank`` added and ranked within its class;
    ``(bias + (1 - bias) * (max_l_num - rank) / max_l_num) ** k``,
    renormalised so the positives' weighted loss (``pos_loss_fn``, the
    cross entropy by default) keeps its sum. -> the new label weights."""
    labels, lw = targets.labels, targets.label_weights
    pos = (labels >= 0) & (labels < num_classes) & (lw > 0)
    safe = labels.clamp(0, num_classes - 1)
    deltas = _class_deltas(bbox_preds, safe)
    pred_boxes = delta2bbox(rois, deltas, target_means, target_stds)
    tgt_boxes = delta2bbox(rois, targets.bbox_targets, target_means,
                           target_stds)
    ious = torch.where(pos, aligned_iou(pred_boxes, tgt_boxes), 0.0)
    per_class = (F.one_hot(safe, num_classes).to(ious.dtype) *
                 pos[:, None]).sum(0)
    max_l_num = per_class.max().clamp(min=1.0)
    same_label = safe[:, None] == safe[None, :]
    same_gt = same_label & (group_ids[:, None] == group_ids[None, :])
    t_rank = rank_desc_within(ious, same_gt, pos)
    ious2 = ious + (max_l_num - t_rank.to(ious.dtype))
    l_rank = rank_desc_within(ious2, same_label, pos)
    w = lw * (max_l_num - l_rank.to(ious.dtype)) / max_l_num
    w = (bias + w * (1.0 - bias)) ** k
    pos_loss = torch.where(pos, (pos_loss_fn or ce_elementwise)(
        cls_scores, safe), 0.0)
    ori = (pos_loss * torch.where(pos, lw, 0.0)).sum()
    new = (pos_loss * torch.where(pos, w, 0.0)).sum()
    w = w * torch.where(new > 0, ori / new.clamp(min=1e-12), 1.0)
    out = torch.where(pos, w, lw)
    return torch.where(pos.sum() > 0, out, lw)


def carl_loss(cls_scores: torch.Tensor, labels: torch.Tensor,
              bbox_preds: torch.Tensor, bbox_targets: torch.Tensor,
              valid_pos: torch.Tensor, num_classes: int, k: float = 1.0,
              bias: float = 0.2, beta: float = 1.0, avg_factor=None,
              sigmoid: bool = False) -> torch.Tensor:
    """CARL: each positive's SmoothL1 (its class's deltas) weighted by
    ``(bias + (1 - bias) * score) ** k`` of its own class score (softmax,
    or sigmoid), the weights renormalised to sum to the positives' count,
    with the gradient to the classifier; over ``avg_factor`` (the slots by
    default)."""
    n = labels.shape[0]
    safe = labels.clamp(0, num_classes - 1)
    pos = valid_pos & (labels >= 0) & (labels < num_classes)
    score = torch.sigmoid(cls_scores) if sigmoid else torch.softmax(
        cls_scores, -1)
    w = (bias + (1.0 - bias) * score.gather(-1, safe[:, None])[:, 0]) ** k
    num_pos = pos.sum()
    w_sum = torch.where(pos, w, 0.0).sum()
    w = w * torch.where(w_sum > 0, num_pos / w_sum.clamp(min=1e-12), 1.0)
    reg = smooth_l1_elementwise(_class_deltas(bbox_preds, safe),
                                bbox_targets, beta).sum(-1)
    loss = torch.where(pos, reg * w, 0.0).sum() / (n if avg_factor is None
                                                   else avg_factor)
    return torch.where(num_pos > 0, loss, 0.0 * cls_scores.sum())


class ScoreHLRSampler(RandomSampler):
    """ISR-N's sampler: positives by the draw; negatives by Score-HLR.
    The negatives whose best foreground softmax is over ``score_thr`` are
    grouped by ``nms_match`` on their boxes decoded at that class, ranked
    by ``num_valid - group rank + score`` and taken first, then the others
    in draw order; the selected ones carry ``(bias + (1 - bias) * w) ** k``
    weights renormalised to their cross entropy against the background
    (1 where no negative is over the threshold). -> (sample, (num,)
    negative weights, 1 off the negatives)."""

    def __init__(self, num: int, pos_fraction: float, neg_pos_ub: int = -1,
                 k: float = 0.5, bias: float = 0.0, score_thr: float = 0.05,
                 iou_thr: float = 0.5):
        super().__init__(num, pos_fraction, neg_pos_ub)
        self.k = k
        self.bias = bias
        self.score_thr = score_thr
        self.iou_thr = iou_thr

    @torch.no_grad()
    def __call__(self, assign, boxes, gt_boxes, priorities: Draws,
                 generator, cls_scores, bbox_preds, num_classes: int,
                 target_means, target_stds):
        n = boxes.shape[0]
        is_pos_cand = assign.gt_inds > 0
        is_neg_cand = assign.gt_inds == 0
        r = draw(priorities, '', n, boxes.device, generator)
        pos_rank = _rank(torch.where(is_pos_cand, r, _BIG))
        sel_pos = is_pos_cand & (pos_rank < self.num_expected_pos)
        num_expected_neg = self.num_expected_neg(sel_pos.sum())

        fg = torch.softmax(cls_scores, -1)[:, :num_classes]
        max_score, argmax_score = fg.max(-1)
        valid_neg = is_neg_cand & (max_score > self.score_thr)
        invalid_neg = is_neg_cand & ~valid_neg
        num_valid = valid_neg.sum()
        pred_boxes = delta2bbox(boxes, _class_deltas(bbox_preds, argmax_score),
                                target_means, target_stds)
        _, grp_rank = nms_match(pred_boxes, max_score, valid_neg,
                                self.iou_thr)
        dt = max_score.dtype
        imp = torch.where(valid_neg, num_valid.to(dt) - grp_rank.to(dt) +
                          max_score, -1.0)
        imp_rank = rank_desc_within(imp, None, valid_neg)
        rand_rank = _rank(torch.where(invalid_neg, r, _BIG))
        neg_key = torch.where(
            valid_neg, imp_rank.float(),
            torch.where(invalid_neg, (n + rand_rank).float(), _BIG))
        neg_rank = _rank(neg_key)
        sel_neg = is_neg_cand & (neg_rank < num_expected_neg) & \
            (neg_key < _BIG)

        num_hlr = torch.minimum(num_valid, num_expected_neg)
        up_bound = torch.maximum(num_expected_neg, num_valid).to(dt)
        w_valid = (up_bound - imp_rank.to(dt)) / up_bound
        w_rand = torch.where(num_hlr > 0, (up_bound - (num_hlr.to(dt) - 1.0))
                             / up_bound, 1.0)
        w = torch.where(valid_neg, w_valid, w_rand)
        w = (self.bias + (1.0 - self.bias) * w) ** self.k
        ori_loss = ce_elementwise(cls_scores, torch.full_like(assign.gt_inds,
                                                              num_classes))
        ori = torch.where(sel_neg, ori_loss, 0.0).sum()
        new = torch.where(sel_neg, ori_loss * w, 0.0).sum()
        w = w * torch.where(new > 0, ori / new.clamp(min=1e-12), 1.0)
        w = torch.where(num_valid > 0, w, 1.0)

        sample = pack(assign, boxes, gt_boxes, sel_pos, pos_rank, sel_neg,
                      neg_rank, self.num)
        neg_weights = torch.where(sample.valid & ~sample.is_pos,
                                  w[sample.inds], 1.0)
        return sample, neg_weights


class PISARoIHead(StandardRoIHead):
    """``StandardRoIHead`` with ISR-N (its sampler, a ``ScoreHLRSampler``,
    scores every candidate with one box forward without a gradient), ISR-P
    over the
    batch's positives grouped by (image, GT), SmoothL1 of ``smooth_l1_beta``
    and CARL; every loss over the count of non-zero label weights, CARL's
    over the slots."""

    def __init__(self, *args, isr_k: float = 2.0, isr_bias: float = 0.0,
                 carl_k: float = 1.0, carl_bias: float = 0.2, **kw):
        super().__init__(*args, **kw)
        self.isr_k = isr_k
        self.isr_bias = isr_bias
        self.carl_k = carl_k
        self.carl_bias = carl_bias

    def _score_all(self, feats, boxes):
        """Every candidate's (cls, deltas) without a gradient: one box
        forward over the (B, A, 4) ``boxes`` (one K2 launch)."""
        b, a = boxes.shape[:2]
        with torch.no_grad():
            rois = boxes.reshape(b * a, 4)
            roi_batch = torch.arange(b, device=rois.device
                                     ).repeat_interleave(a)
            cls_all, reg_all = self._bbox_forward(feats, rois, roi_batch)
        return cls_all.reshape(b, a, -1), reg_all.reshape(b, a, -1)

    def _sample_hlr(self, feats, proposals, proposal_valid, batch, priorities,
                    generator):
        """Each image's candidates assigned and sampled by Score-HLR (a
        ``sampler`` range an image), its scores from one forward over the
        batch (the ``score_hlr`` range): (the stacked sample, (B, num)
        negative weights)."""
        cands = []
        for i in range(proposals.shape[0]):
            boxes, valid = proposals[i], proposal_valid[i].bool()
            if self.add_gt_as_proposals:
                boxes, valid = add_gt_as_proposals(
                    boxes, valid, batch['gt_boxes'][i], batch['gt_valid'][i])
            cands.append((boxes, valid))
        with record_function('score_hlr'):
            cls_all, reg_all = self._score_all(
                feats, torch.stack([c[0] for c in cands]))
        samples, weights = [], []
        for i, (boxes, valid) in enumerate(cands):
            with record_function('sampler'):
                gts = batch['gt_boxes'][i]
                assign = self.assigner(boxes, valid, gts,
                                       batch['gt_valid'][i],
                                       batch['gt_labels'][i])
                sample, w = self.sampler(
                    assign, boxes, gts, image_draws(priorities, i),
                    generator, cls_all[i], reg_all[i], self.num_classes,
                    self.target_means, self.target_stds)
            samples.append(sample)
            weights.append(w)
        return stack_samples(samples), torch.stack(weights)

    def forward_train(self, feats, proposals: torch.Tensor,
                      proposal_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The box losses with ISR-N / ISR-P weights and CARL on the
        sampled RoIs, then the mask branch's; ``noise['rcnn']`` (B, A) the
        sampler's draws (positives and low-score negatives)."""
        noise = noise or {}
        with record_function('box_branch'):
            sample, neg_w = self._sample_hlr(
                feats, proposals, proposal_valid, batch,
                sampler_draws(noise, 'rcnn'), generator)
            b, n = sample.boxes.shape[:2]
            rois = sample.boxes.reshape(b * n, 4)
            roi_batch = torch.arange(b, device=rois.device
                                     ).repeat_interleave(n)
            cls_logits, bbox_deltas = self._bbox_forward(feats, rois,
                                                         roi_batch)
            flat = SamplingResult(*[t.reshape((b * n,) + t.shape[2:])
                                    for t in sample])
            t = bbox_targets_from_sample(flat, self.num_classes,
                                         self.target_means, self.target_stds)
            t = t._replace(label_weights=t.label_weights *
                           neg_w.reshape(b * n).to(t.label_weights.dtype))
            group_ids = (roi_batch * batch['gt_boxes'].shape[1] +
                         flat.gt_inds)
            lw = isr_p_label_weights(
                cls_logits, bbox_deltas, t, rois, group_ids,
                self.num_classes, self.target_means, self.target_stds,
                k=self.isr_k, bias=self.isr_bias)
            avg = (lw > 0).sum().clamp(min=1).to(cls_logits.dtype)
            loss_cls = softmax_cross_entropy(cls_logits, t.labels, lw, avg)
            acc = accuracy(cls_logits, t.labels, (lw > 0).float())
            pred = _class_deltas(bbox_deltas,
                                 t.labels.clamp(0, self.num_classes - 1))
            reg = smooth_l1_elementwise(pred, t.bbox_targets,
                                        self.smooth_l1_beta).sum(-1)
            loss_bbox = (reg * t.bbox_weights).sum() / avg
            loss_carl = carl_loss(
                cls_logits, t.labels, bbox_deltas, t.bbox_targets,
                t.bbox_weights > 0, self.num_classes, self.carl_k,
                self.carl_bias, self.smooth_l1_beta, b * n)
            losses = {'loss_cls': self.loss_cls_weight * loss_cls,
                      'loss_bbox': self.loss_bbox_weight * loss_bbox,
                      'loss_carl': loss_carl, 'acc': acc}
        if self.mask_head is None:
            return losses
        with record_function('mask_branch'):
            losses.update(self._mask_forward_train(
                feats, sample, batch, self._mask_draws(noise), generator))
        return losses


def isr_p_dense(cls_flat: torch.Tensor, reg_flat: torch.Tensor,
                labels: torch.Tensor, label_weights: torch.Tensor,
                bbox_targets: torch.Tensor, rois: torch.Tensor,
                group_ids: torch.Tensor, num_classes: int, target_means,
                target_stds, k: float = 2.0, bias: float = 0.0,
                cap: int = 512, pos_loss_fn: Optional[Callable] = None
                ) -> torch.Tensor:
    """ISR-P over a batch-flat dense anchor set: the first ``cap`` slots of
    the positives-first order (positives in anchor order) reweighted by
    :func:`isr_p_label_weights`, the others unchanged. The cap is over the
    whole batch, as in JAX (ROADMAP.md queue 3, 3bk): past ``cap``
    positives the rest keep their weight."""
    pos = (labels >= 0) & (labels < num_classes) & (label_weights > 0)
    cap = min(cap, labels.shape[0])
    idx = torch.argsort((~pos).int(), stable=True)[:cap]
    sub = BBoxTargets(labels[idx], label_weights[idx], bbox_targets[idx],
                      label_weights[idx])
    new = isr_p_label_weights(cls_flat[idx], reg_flat[idx], sub, rois[idx],
                              group_ids[idx], num_classes, target_means,
                              target_stds, pos_loss_fn, k, bias)
    return label_weights.index_put((idx,), new)


def _flat_groups(gt_idx: torch.Tensor, num_gts: int) -> torch.Tensor:
    """(B, A) GT indices -> batch-flat (image, GT) group ids."""
    b, a = gt_idx.shape
    img = torch.arange(b, device=gt_idx.device).repeat_interleave(a)
    return img * num_gts + gt_idx.reshape(b * a)


@DETECTORS.register_module()
class PISASSD(SSD):
    """SSD with ISR-P on its positives (the hard negatives mined on the
    unweighted cross entropy) and CARL (SmoothL1 at beta 1.0, over the
    batch's positives)."""

    def __init__(self, *args, isr_k: float = 2.0, isr_bias: float = 0.0,
                 carl_k: float = 1.0, carl_bias: float = 0.2, **kw):
        super().__init__(*args, **kw)
        self.isr = dict(k=isr_k, bias=isr_bias)
        self.carl = dict(k=carl_k, bias=carl_bias)

    def forward_train(self, batch, noise=None, generator=None):
        flat_cls, flat_reg, anchors, (labels, pos, keep_neg, gt_idx, tgt,
                                      _) = self.targets(batch)
        with record_function('loss'):
            b, a = labels.shape
            nc = self.num_classes
            cls2 = flat_cls.reshape(b * a, nc + 1)
            reg2 = flat_reg.reshape(b * a, 4)
            tgt2 = tgt.reshape(b * a, 4)
            labels = labels.reshape(b * a)
            posm = pos.reshape(b * a)
            lw = isr_p_dense(
                cls2, reg2, labels, (posm | keep_neg.reshape(b * a)).to(
                    cls2.dtype), tgt2, anchors.repeat(b, 1),
                _flat_groups(gt_idx, batch['gt_boxes'].shape[1]), nc,
                self.bbox_coder.means, self.bbox_coder.stds, **self.isr)
            total_pos = pos.sum().clamp(min=1).to(cls2.dtype)
            loss_cls = (ce_elementwise(cls2, labels) * lw).sum() / total_pos
            reg_l = (smooth_l1_elementwise(reg2, tgt2, self.smoothl1_beta) *
                     posm[:, None]).sum()
            loss_carl = carl_loss(cls2, labels, reg2, tgt2, posm, nc,
                                  beta=1.0, avg_factor=total_pos, **self.carl)
            return {'loss_cls': loss_cls, 'loss_bbox': reg_l / total_pos,
                    'loss_carl': loss_carl}


@DETECTORS.register_module()
class PISARetinaNet(SingleStageDetector):
    """RetinaNet with ISR-P on its positives (the focal loss as the
    positives' loss) and CARL on sigmoid scores (SmoothL1 at
    ``carl_beta``); the box loss is L1 on the positives, as in JAX."""

    def __init__(self, *args, isr_k: float = 2.0, isr_bias: float = 0.0,
                 carl_k: float = 1.0, carl_bias: float = 0.2,
                 carl_beta: float = 0.11, **kw):
        super().__init__(*args, **kw)
        self.isr = dict(k=isr_k, bias=isr_bias)
        self.carl = dict(k=carl_k, bias=carl_bias, beta=carl_beta)

    def forward_train(self, batch, noise=None, generator=None):
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            mlvl, sizes = self.anchors(feats)
            anchors = torch.cat(mlvl)
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            nc = self.num_classes
            flat_cls = flatten_levels(cls_scores, nc)
            flat_reg = flatten_levels(bbox_preds, 4)
            k = batch['gt_boxes'].shape[1]
            rows = [[] for _ in range(4)]
            for i in range(flat_cls.shape[0]):
                a = self.assigner(anchors, valid[i], batch['gt_boxes'][i],
                                  batch['gt_valid'][i], batch['gt_labels'][i])
                p = a.gt_inds > 0
                inc = p | ((a.gt_inds == 0) & valid[i].bool())
                gt_idx = (a.gt_inds - 1).clamp(0, k - 1)
                for lst, v in zip(rows, (torch.where(p, a.labels, nc), p, inc,
                                         gt_idx)):
                    lst.append(v)
            labels, pos, include, gt_idx = (torch.stack(v) for v in rows)
            tgt = torch.stack([self.bbox_coder.encode(
                anchors, batch['gt_boxes'][i][gt_idx[i]])
                for i in range(labels.shape[0])])
            b, m = labels.shape[0], labels.numel()
            cls2, reg2 = flat_cls.reshape(m, nc), flat_reg.reshape(m, 4)
            tgt2, labels, posm = tgt.reshape(m, 4), labels.reshape(m), \
                pos.reshape(m)
            gamma, alpha = (self.loss_cfg['focal_gamma'],
                            self.loss_cfg['focal_alpha'])

            def focal_rows(cls_s, lbl):
                return focal_elementwise(cls_s, one_hot_fg(lbl, lbl < nc, nc)
                                         .to(cls_s.dtype), gamma,
                                         alpha).sum(-1)

            lw = isr_p_dense(cls2, reg2, labels, include.reshape(m).to(
                cls2.dtype), tgt2, anchors.repeat(b, 1),
                _flat_groups(gt_idx, k), nc, self.bbox_coder.means,
                self.bbox_coder.stds, pos_loss_fn=focal_rows, **self.isr)
            total_pos = pos.sum().clamp(min=1).to(cls2.dtype)
            onehot = one_hot_fg(labels, posm, nc).to(cls2.dtype)
            loss_cls = (focal_elementwise(cls2, onehot, gamma, alpha) *
                        lw[:, None]).sum() / total_pos
            reg_l = ((reg2 - tgt2).abs() * posm[:, None]).sum() / total_pos
            loss_carl = carl_loss(cls2, labels, reg2, tgt2, posm, nc,
                                  avg_factor=total_pos, sigmoid=True,
                                  **self.carl)
            return {'loss_cls': loss_cls, 'loss_bbox': reg_l,
                    'loss_carl': loss_carl}
