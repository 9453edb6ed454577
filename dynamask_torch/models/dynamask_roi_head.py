"""DynaMask RoI head (port of ``dynamask_tpu/models/dynamask_roi_head.py``:
``routing_clip_stats``, ``dyna_mask_loss`` :74-158, ``flops_budget_loss``
:161-170, ``_msm_labels`` :238-263, ``_mask_forward_train`` :273-297,
``_fuse_pair``, ``_dynamic_test_mask`` :314-382, ``simple_test_mask``
:384-419).

Training runs the whole cascade on every positive slot; the MSM's
straight-through Gumbel one-hot only weights the losses. Faithful loss
quirks kept: with ``start_stage=4`` every stage takes the plain-BCE branch,
the mask loss is the LAST stage's instance BCE plus the routing-weighted
detail losses plus the class-balance term, and the detail losses' normaliser
is detached.

Two modes, one module, the same two kernels:

* faithful (``dynamic_inference=False``, the config as shipped): the full
  cascade for every det slot, then boundary-aware fusion from stage 1 on —
  outside the coarser stage's predicted boundary band its upsampled logits
  overwrite the finer stage's;
* MSM-routed buckets (``dynamic_inference=True``): the Mask Switch Module
  scores a 56×56 crop of the W-projected P2 per det, RoIs are sorted by the
  chosen resolution, and each stage runs on a static prefix of the sorted
  RoIs (``dynamic_capacity`` fractions); every bucket is lifted to 112.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..core.boundary import (detail_target, generate_block_target,
                             interpolate_bilinear)
from ..core.mask_targets import mask_targets_from_crops
from ..ops.roi_align import roi_align
from ..utils.registry import HEADS
from .dynamask_head import DynaMaskHead, MaskPre, gumbel_softmax
from .layers import to_nchw, to_nhwc
from .losses import binary_cross_entropy_with_logits
from .roi_head import StandardRoIHead


def routing_clip_stats(need: torch.Tensor,
                       caps: Sequence[int]) -> Dict[str, torch.Tensor]:
    """MSM routing accounting against the static capacities
    ``caps = (n, k1, k2, k3)``: ``hist`` (4,) RoIs per chosen resolution,
    ``demand`` (3,) RoIs asking for stage >= 1/2/3, ``capacity`` (3,) and
    ``clipped`` (3,) RoIs demoted at each stage boundary. Padded det slots
    count too: they take capacity like any other."""
    need = need.reshape(-1)
    hist = torch.stack([(need == k).sum() for k in range(4)])
    demand = torch.stack([(need >= j).sum() for j in (1, 2, 3)])
    kcaps = torch.tensor(caps[1:4], device=need.device)
    return {'hist': hist, 'demand': demand, 'capacity': kcaps,
            'clipped': (demand - kcaps).clamp(min=0)}


def dyna_mask_loss(stage_instance_preds: Sequence[torch.Tensor],
                   stage_detail_preds: Sequence[torch.Tensor],
                   stage_targets: Sequence[torch.Tensor],
                   mask_labels: torch.Tensor, pos_valid: torch.Tensor,
                   detail_fuse_weights: torch.Tensor,
                   stage_detail_loss_weight: Sequence[float] = (0.5,) * 4,
                   cb_loss_weight: float = 0.8, start_stage: int = 4,
                   stage_instance_loss_weight: Optional[Sequence[float]] =
                   None) -> Dict[str, torch.Tensor]:
    """DynaCrossEntropyLoss in masked form. Stage logits (R, 1, s, s),
    targets (R, s, s), ``mask_labels`` (R, stages) the routing one-hot,
    ``pos_valid`` (R,). ``stage_instance_loss_weight=None`` keeps the
    faithful last-stage-only instance BCE."""
    v = pos_valid.float()
    nv = v.sum().clamp(min=1.0)
    last_inst = torch.zeros((), device=v.device)
    inst_losses, detail_losses = [], []
    for idx in range(len(stage_instance_preds)):
        if idx > start_stage:
            continue
        inst = stage_instance_preds[idx][:, 0]
        det = stage_detail_preds[idx][:, 0]
        target = stage_targets[idx]
        det_target = detail_target(target, detail_fuse_weights)
        bce = binary_cross_entropy_with_logits(inst, target)
        last_inst = (bce.mean((1, 2)) * v).sum() / nv
        inst_losses.append(last_inst)
        w_roi = mask_labels[:, idx] * v
        x = torch.sigmoid(det)
        ll = det_target * torch.log(x.clamp(min=1e-10)) + \
            (1.0 - det_target) * torch.log((1.0 - x).clamp(min=1e-10))
        px = det.shape[1] * det.shape[2]
        # the reference detaches the normaliser: the routing weights get
        # gradient through the numerator only
        n_routed = w_roi.sum().detach()
        detail_losses.append(-(ll.sum((1, 2)) * w_roi).sum() /
                             (px * (n_routed + 1e-5)))
    counts = (mask_labels * v[:, None]).sum(0)
    dist = counts / counts.sum().clamp(min=1e-6)
    loss_cb = (dist * torch.log(dist.clamp(min=1e-10))).sum()
    loss_detail = sum(w * l for w, l in zip(stage_detail_loss_weight,
                                            detail_losses))
    if stage_instance_loss_weight is not None:
        loss_inst = sum(w * l for w, l in zip(stage_instance_loss_weight,
                                              inst_losses))
    else:
        loss_inst = last_inst
    return {'loss_masks': loss_inst + loss_detail +
            cb_loss_weight * loss_cb}


def flops_budget_loss(mask_labels: torch.Tensor, pos_valid: torch.Tensor,
                      flops: Sequence[float], lam: float,
                      target: float = 1.0) -> torch.Tensor:
    """Λ·clamp((E[flops per RoI] − target) / (flops_max − flops_min),
    min=0) over the valid RoIs."""
    v = pos_valid.float()
    f = torch.tensor(flops, dtype=torch.float32, device=v.device)
    expected = (mask_labels * v[:, None] * f[None, :]).sum() / \
        v.sum().clamp(min=1.0)
    return lam * ((expected - target) / (f[-1] - f[0])).clamp(min=0.0)


def stage_capacities(n: int, capacity: Sequence[float]
                     ) -> Tuple[int, int, int, int]:
    """Static admission counts (n, k1, k2, k3) of the 28/56/112 stages."""
    cap = tuple(capacity)
    if len(cap) != 3:
        raise ValueError(f'dynamic_capacity needs the 3 fractions of the '
                         f'28/56/112 stages, got {cap}')
    k1 = max(1, int(round(n * cap[0])))
    k2 = max(1, min(k1, int(round(n * cap[1]))))
    k3 = max(1, min(k2, int(round(n * cap[2]))))
    return n, k1, k2, k3


# the MSM's 56×56 crop of P2 (stride 4, base_roi_head.py:53-58) and the
# boundary width of the test-time fusion
MSM_OUT_SIZE = 56
MSM_STRIDE = 4
TEST_BOUNDARY_WIDTH = 1


@HEADS.register_module()
class DynaMaskRoIHead(StandardRoIHead):
    def __init__(self, bbox_head, mask_head: DynaMaskHead,
                 mask_predictor: MaskPre, dynamic_inference: bool = False,
                 dynamic_capacity: Tuple[float, ...] = (0.5, 0.25, 0.125),
                 stage_sup_size: Tuple[int, ...] = (14, 28, 56, 112),
                 stage_detail_loss_weight: Tuple[float, ...] = (0.5,) * 4,
                 stage_instance_loss_weight: Optional[Tuple[float, ...]] =
                 None, cb_loss_weight: float = 0.8, start_stage: int = 4,
                 flops_cost: Tuple[float, ...] = (0.23, 0.62, 1.01, 1.4),
                 flops_lambda: float = 0.3, flops_target: float = 1.0,
                 gumbel_temperature: float = 0.5, **common):
        super().__init__(bbox_head, **common)
        self.mask_head = mask_head
        self.mask_predictor = mask_predictor
        self.dynamic_inference = dynamic_inference
        self.dynamic_capacity = tuple(dynamic_capacity)
        self.stage_sup_size = tuple(stage_sup_size)
        self.stage_detail_loss_weight = tuple(stage_detail_loss_weight)
        self.stage_instance_loss_weight = stage_instance_loss_weight
        self.cb_loss_weight = cb_loss_weight
        self.start_stage = start_stage
        self.flops_cost = tuple(flops_cost)
        self.flops_lambda = flops_lambda
        self.flops_target = flops_target
        self.gumbel_temperature = gumbel_temperature

    def _mask_forward(self, feats, rois, roi_batch, roi_labels,
                      stage_max_rois=None):
        ins = to_nchw(self._extract(feats, rois, roi_batch,
                                    self.mask_roi_out))
        return self.mask_head(ins, feats, rois, roi_batch, roi_labels,
                              stage_max_rois)

    def _msm_labels(self, feats, rois, roi_batch, u=None, generator=None):
        """Routing one-hot of the training step: a detached P2, the MSM's
        W-only projection, a 56×56 crop at ratio 1 (K2, gradient by K4 to
        the projection), the MSM head, then straight-through Gumbel."""
        proj = self.mask_predictor(feats[0].detach(), 'project')
        crops = roi_align(to_nhwc(proj), rois, roi_batch, MSM_OUT_SIZE,
                          1.0 / MSM_STRIDE, sampling_ratio=1)
        logits = self.mask_predictor(to_nchw(crops), 'head')
        return gumbel_softmax(logits, self.gumbel_temperature, hard=True,
                              u=u, generator=generator)

    def _mask_forward_train(self, feats, sample, batch, gumbel_u=None,
                            generator=None):
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        preds, details = self._mask_forward(feats, boxes, roi_batch, labels)
        targets = [mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], s) for s in self.stage_sup_size]
        mask_labels = self._msm_labels(feats, boxes, roi_batch, gumbel_u,
                                       generator)
        fuse = self.mask_head.loss_func.detail_target.fuse_kernel
        losses = dyna_mask_loss(preds, details, targets, mask_labels, valid,
                                fuse, self.stage_detail_loss_weight,
                                self.cb_loss_weight, self.start_stage,
                                self.stage_instance_loss_weight)
        losses['loss_flops'] = flops_budget_loss(
            mask_labels, valid, self.flops_cost, self.flops_lambda,
            self.flops_target)
        return losses

    def _fuse_pair(self, cur: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
        """Boundary-aware fusion of (R, s, s) logits into (R, 2s, 2s)."""
        s = nxt.shape[-1]
        binary = (torch.sigmoid(cur) >= 0.5).float()
        nb = (generate_block_target(
            binary, boundary_width=TEST_BOUNDARY_WIDTH) != 1).float()
        nb_up = interpolate_bilinear(nb, s, s, align_corners=True) >= 0.5
        cur_up = interpolate_bilinear(cur, s, s, align_corners=True)
        return torch.where(nb_up, cur_up, nxt)

    def _rois(self, dets, batch, rescale):
        b, d = dets.shape[:2]
        boxes = dets[..., :4]
        if rescale:  # back to input scale for RoI extraction
            boxes = boxes * batch['scale_factor'][:, None, :]
        roi_batch = torch.arange(b, device=dets.device).repeat_interleave(d)
        return boxes.reshape(b * d, 4), roi_batch

    def _dynamic_test_mask(self, feats, dets, labels, batch, rescale,
                           routing: Optional[dict] = None):
        b, d = dets.shape[:2]
        n = b * d
        rois, roi_batch = self._rois(dets, batch, rescale)
        flat_labels = labels.reshape(n)
        # routing decision: argmax at test (no Gumbel noise); the crop runs
        # after the W-only projection of P2 (exact, see MaskPre)
        proj = self.mask_predictor(feats[0], 'project')
        crops = roi_align(to_nhwc(proj), rois, roi_batch, MSM_OUT_SIZE,
                          1.0 / MSM_STRIDE, sampling_ratio=1)
        route_logits = self.mask_predictor(to_nchw(crops), 'head')
        need = torch.argmax(route_logits, -1)            # 0..3, 3 = finest
        order = torch.argsort(-need, stable=True)
        inv_order = torch.argsort(order)
        caps = stage_capacities(n, self.dynamic_capacity)
        k1, k2, k3 = caps[1:]
        if routing is not None:
            routing.update(routing_clip_stats(need, caps), need=need)

        preds, _ = self._mask_forward(feats, rois[order], roi_batch[order],
                                      flat_labels[order], caps)
        p0, p1, p2s, p3s = (p[:, 0] for p in preds)
        fused56 = self._fuse_pair(p1[:k2], p2s)
        fused112 = self._fuse_pair(fused56[:k3], p3s)
        final = interpolate_bilinear(p0, 112, 112, align_corners=True)
        final[:k1] = interpolate_bilinear(p1, 112, 112, align_corners=True)
        final[:k2] = interpolate_bilinear(fused56, 112, 112,
                                          align_corners=True)
        final[:k3] = fused112
        probs = torch.sigmoid(final)[inv_order]
        return probs.reshape(b, d, 112, 112)

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        """(B, D, 112, 112) final-resolution mask probabilities; in dynamic
        mode ``routing`` (if given) receives the MSM routing statistics."""
        if self.dynamic_inference:
            return self._dynamic_test_mask(feats, dets, labels, batch,
                                           rescale, routing)
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        preds, _ = self._mask_forward(feats, rois, roi_batch,
                                      labels.reshape(b * d))
        # refine from stage 1 on (the reference drops stage 0 here)
        fused = preds[1][:, 0]
        for p in preds[2:]:
            fused = self._fuse_pair(fused, p[:, 0])
        probs = torch.sigmoid(fused)
        return probs.reshape(b, d, *probs.shape[1:])
