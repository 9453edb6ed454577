"""Dynamic R-CNN's RoI head (port of ``dynamask_tpu/models/
dynamic_rcnn.py``: ``DynamicRoIHead`` :37).

The assigner's IoU threshold and the SmoothL1 beta follow the training
statistics: each step records the mean over images of the ``iou_topk``-th
largest proposal IoU and the ``beta_topk * B``-th smallest mean |xy
delta| of the positives, and every ``update_iter_interval`` steps sets
``iou_thr = max(initial_iou, mean(iou history))`` and ``beta =
min(initial_beta, median(beta history))``.

As in JAX, where this state lives in ``batch_stats``, it is the head's
registered buffers (``dyn_iou_thr``, ``dyn_beta``, ``dyn_iou_hist``,
``dyn_beta_hist``, ``dyn_step``), updated on the device inside the step:
the k-th value is a full sort and a clipped index, the update a
``torch.where`` on the step count, so no step reads a value back to the
host.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.assigners import MaxIoUAssigner
from ..core.samplers import SamplingResult
from ..utils.registry import HEADS
from .bbox_head import bbox_targets_from_sample
from .losses import accuracy, smooth_l1_elementwise, softmax_cross_entropy
from .roi_head import StandardRoIHead


def jax_median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count
    (``torch.median`` takes the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2


class _KthIoU:
    """An assigner that keeps, of each image it assigns, the ``k``-th
    largest of its candidates' max IoUs."""

    def __init__(self, assigner: MaxIoUAssigner, k: int):
        self.assigner, self.k, self.kth = assigner, k, []

    def __call__(self, boxes, *args):
        assign = self.assigner(boxes, *args)
        k = min(self.k, boxes.shape[0])
        self.kth.append(torch.topk(assign.max_overlaps, k).values[-1])
        return assign


@HEADS.register_module()
class DynamicRoIHead(StandardRoIHead):
    """``StandardRoIHead`` whose training assigns at ``dyn_iou_thr``
    (positive, negative and low-quality thresholds alike, starting at
    ``pos_iou_thr``) and regresses with SmoothL1 of ``dyn_beta``."""

    def __init__(self, bbox_head, iou_topk: int = 75, beta_topk: int = 10,
                 initial_iou: float = 0.4, initial_beta: float = 1.0,
                 update_iter_interval: int = 100, **common):
        super().__init__(bbox_head, None, **common)
        self.iou_topk = iou_topk
        self.beta_topk = beta_topk
        self.initial_iou = initial_iou
        self.initial_beta = initial_beta
        self.update_iter_interval = update_iter_interval
        n = update_iter_interval
        self.register_buffer('dyn_iou_thr', torch.empty(()))
        self.register_buffer('dyn_beta', torch.empty(()))
        self.register_buffer('dyn_iou_hist', torch.empty(n))
        self.register_buffer('dyn_beta_hist', torch.empty(n))
        self.register_buffer('dyn_step', torch.empty((), dtype=torch.int32))
        self.init_buffers()

    def init_buffers(self) -> None:
        """The state before the first step: the config's threshold and
        ``initial_beta``, empty histories (again after the detector is
        materialised from the ``meta`` device)."""
        with torch.no_grad():
            self.dyn_iou_thr.fill_(self.assigner.pos_iou_thr)
            self.dyn_beta.fill_(self.initial_beta)
            self.dyn_iou_hist.zero_()
            self.dyn_beta_hist.zero_()
            self.dyn_step.zero_()

    def forward_train(self, feats, proposals, proposal_valid, batch,
                      noise=None, generator=None) -> Dict[str, torch.Tensor]:
        noise = noise or {}
        thr = self.dyn_iou_thr.clone()
        beta = self.dyn_beta.clone()
        assigner = _KthIoU(MaxIoUAssigner(
            thr, thr, thr, match_low_quality=self.assigner.match_low_quality),
            self.iou_topk)
        sample = self._sample_rois(proposals, proposal_valid, batch,
                                   noise.get('rcnn'), generator, assigner)
        cur_iou = torch.stack(assigner.kth).mean()
        b, n = sample.boxes.shape[:2]
        rois = sample.boxes.reshape(b * n, 4)
        roi_batch = torch.arange(b, device=rois.device).repeat_interleave(n)
        cls_logits, deltas = self._bbox_forward(feats, rois, roi_batch)
        flat = SamplingResult(*[t.reshape((b * n,) + t.shape[2:])
                                for t in sample])
        t = bbox_targets_from_sample(flat, self.num_classes,
                                     self.target_means, self.target_stds)
        # the beta statistic (reference dynamic_roi_head.py:116-125)
        pos_w = t.bbox_weights
        xy_err = t.bbox_targets[:, :2].abs().mean(-1)
        ordered = torch.sort(torch.where(pos_w > 0, xy_err,
                                         float('inf'))).values
        kth_beta = pos_w.sum().long().clamp(max=self.beta_topk * b)
        cur_beta = ordered[(kth_beta - 1).clamp(0, ordered.shape[0] - 1)]
        cur_beta = torch.where(torch.isfinite(cur_beta), cur_beta,
                               self.initial_beta)
        avg = t.label_weights.sum()
        loss_cls = softmax_cross_entropy(cls_logits, t.labels,
                                         t.label_weights, avg)
        safe = t.labels.clamp(0, self.num_classes - 1)
        pred = deltas.reshape(b * n, self.num_classes, 4)[
            torch.arange(b * n, device=safe.device), safe]
        lb = smooth_l1_elementwise(pred, t.bbox_targets, beta)
        loss_bbox = (lb * t.bbox_weights[:, None]).sum() / avg.clamp(min=1.0)
        losses = {'loss_cls': self.loss_cls_weight * loss_cls,
                  'loss_bbox': self.loss_bbox_weight * loss_bbox,
                  'acc': accuracy(cls_logits, t.labels, t.label_weights)}
        self._update_state(cur_iou.detach(), cur_beta.detach())
        return losses

    @torch.no_grad()
    def _update_state(self, cur_iou: torch.Tensor, cur_beta: torch.Tensor):
        interval = self.update_iter_interval
        step = self.dyn_step.long()
        slot = torch.arange(interval, device=step.device) == step % interval
        iou_hist = torch.where(slot, cur_iou, self.dyn_iou_hist)
        beta_hist = torch.where(slot, cur_beta, self.dyn_beta_hist)
        update = (step + 1) % interval == 0
        self.dyn_iou_thr.copy_(torch.where(
            update, iou_hist.mean().clamp(min=self.initial_iou),
            self.dyn_iou_thr))
        self.dyn_beta.copy_(torch.where(
            update, jax_median(beta_hist).clamp(max=self.initial_beta),
            self.dyn_beta))
        self.dyn_iou_hist.copy_(iou_hist)
        self.dyn_beta_hist.copy_(beta_hist)
        self.dyn_step.add_(1)
