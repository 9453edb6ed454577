"""FreeAnchor (port of ``dynamask_tpu/models/freeanchor.py``): the RetinaNet
body trained by maximum-likelihood anchor bags instead of IoU assignment.
Each GT's bag is its ``pre_anchor_topk`` anchors of highest IoU, whose
mean-max of class x box probability it maximises; every anchor pays a
focal negative loss damped by its probability of covering an object of
the class (the saturated-linear IoU of its decoded box).

JAX's dense form, per image: the (anchor, class) object probability is
the max over the GTs of that class, here one ``scatter_reduce`` rather
than a (GT, anchor, class) product.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.profiler import record_function

from ..core.bbox_transforms import bbox2delta, bbox_overlaps, delta2bbox
from ..utils.registry import DETECTORS
from .losses import smooth_l1_elementwise
from .single_stage import SingleStageDetector, flatten_levels


def top_anchors(iou: torch.Tensor, k: int) -> torch.Tensor:
    """The (G, k) indices of each row's k largest IoUs, the lower index
    first among ties, as ``jax.lax.top_k`` takes them."""
    return torch.sort(iou, dim=1, descending=True, stable=True
                      ).indices[:, :k]


def free_anchor_loss(flat_cls: torch.Tensor, flat_reg: torch.Tensor,
                     anchors: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                     num_classes: int, means, stds, pre_anchor_topk: int = 50,
                     bbox_thr: float = 0.6, gamma: float = 2.0,
                     alpha: float = 0.5, beta: float = 0.11,
                     loss_bbox_weight: float = 0.75
                     ) -> Dict[str, torch.Tensor]:
    """The positive and negative bag losses of (B, A, C) logits and
    (B, A, 4) deltas over (A, 4) anchors."""
    k = pre_anchor_topk
    pos_l, neg_l, num_pos = [], [], []
    for cls_s, reg_s, gts, labels, gvalid in zip(flat_cls, flat_reg,
                                                 gt_boxes, gt_labels,
                                                 gt_valid):
        cls_prob = torch.sigmoid(cls_s)                          # (A, C)
        gvf = gvalid.float()
        safe = labels.long().clamp(0, num_classes - 1)
        with torch.no_grad():
            pred = delta2bbox(anchors, reg_s, means, stds)
            iou = bbox_overlaps(gts, pred) * gvf[:, None]        # (G, A)
            t2 = iou.max(1, keepdim=True).values.clamp(min=bbox_thr + 1e-12)
            obj = ((iou - bbox_thr) / (t2 - bbox_thr)).clamp(0, 1)
            box_prob = torch.zeros_like(cls_prob).scatter_reduce_(
                1, safe[None, :].expand(obj.shape[1], -1),
                (obj * gvf[:, None]).T, reduce='amax')           # (A, C)
        matched = top_anchors(bbox_overlaps(gts, anchors), k)   # (G, K)
        m_cls = cls_prob[matched, safe[:, None]]                 # (G, K)
        m_anchors = anchors[matched]
        m_targets = bbox2delta(m_anchors, gts[:, None, :].expand_as(
            m_anchors), means, stds)
        lb = loss_bbox_weight * smooth_l1_elementwise(
            reg_s[matched], m_targets, beta).sum(-1)
        mp = m_cls * torch.exp(-lb)
        w = 1.0 / (1 - mp).clamp(min=1e-12)
        w = w / w.sum(1, keepdim=True)
        bag = (w * mp).sum(1)
        pos_l.append((-alpha * torch.log(bag.clamp(1e-12, 1.0)) * gvf).sum())
        prob = cls_prob * (1 - box_prob)
        neg_l.append((1 - alpha) * (prob ** gamma * -torch.log(
            (1 - prob).clamp(1e-12, 1.0))).sum())
        num_pos.append(gvf.sum())
    total = torch.stack(num_pos).sum().clamp(min=1.0)
    return {'positive_bag_loss': torch.stack(pos_l).sum() / total,
            'negative_bag_loss': torch.stack(neg_l).sum() / (total * k)}


@DETECTORS.register_module()
class FreeAnchor(SingleStageDetector):
    """RetinaNet with FreeAnchor's bag objective (``FreeAnchorRetinaHead``);
    its test path is RetinaNet's."""

    def __init__(self, *args, pre_anchor_topk: int = 50,
                 bbox_thr: float = 0.6, fa_gamma: float = 2.0,
                 fa_alpha: float = 0.5, smoothl1_beta: float = 0.11,
                 **kwargs):
        kwargs.setdefault('loss_bbox_weight', 0.75)
        super().__init__(*args, **kwargs)
        self.bag_cfg = dict(pre_anchor_topk=pre_anchor_topk,
                            bbox_thr=bbox_thr, gamma=fa_gamma,
                            alpha=fa_alpha, beta=smoothl1_beta,
                            loss_bbox_weight=self.loss_cfg[
                                'loss_bbox_weight'])

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The two bag losses (every anchor takes part, as in JAX: no valid
        flags)."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            mlvl, _ = self.anchors(feats)
            return free_anchor_loss(
                flatten_levels(cls_scores, self.num_classes),
                flatten_levels(bbox_preds, 4), torch.cat(mlvl),
                batch['gt_boxes'], batch['gt_labels'], batch['gt_valid'],
                self.num_classes, self.bbox_coder.means,
                self.bbox_coder.stds, **self.bag_cfg)
