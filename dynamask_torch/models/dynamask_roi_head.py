"""DynaMask RoI head at inference (port of
``dynamask_tpu/models/dynamask_roi_head.py``: ``routing_clip_stats``,
``_fuse_pair``, ``_dynamic_test_mask`` :314-382, ``simple_test_mask``
:384-419).

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

from ..core.boundary import generate_block_target, interpolate_bilinear
from ..ops.roi_align import roi_align
from ..utils.registry import HEADS
from .dynamask_head import DynaMaskHead, MaskPre
from .layers import to_nchw, to_nhwc
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
                 **common):
        super().__init__(bbox_head, **common)
        self.mask_head = mask_head
        self.mask_predictor = mask_predictor
        self.dynamic_inference = dynamic_inference
        self.dynamic_capacity = tuple(dynamic_capacity)

    def _mask_forward(self, feats, rois, roi_batch, roi_labels,
                      stage_max_rois=None):
        ins = to_nchw(self._extract(feats, rois, roi_batch,
                                    self.mask_roi_out))
        return self.mask_head(ins, feats, rois, roi_batch, roi_labels,
                              stage_max_rois)

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
