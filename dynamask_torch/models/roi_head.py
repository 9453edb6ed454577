"""Box branch of the two-stage RoI head (port of
``dynamask_tpu/models/roi_head.py``: ``StandardRoIHead._extract``,
``_bbox_forward`` and ``simple_test``, :187-316). RoI features come from the
FPN-routed RoIAlign (kernel K2) with the static ``sampling_ratio`` 2."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..ops.roi_align import multilevel_roi_align
from .bbox_head import bbox_head_get_dets
from .layers import to_nhwc


# the static sampling ratio of the JAX package (not the configs' adaptive 0)
# and the FPN routing scale of map_roi_levels
ROI_SAMPLING_RATIO = 2
FINEST_SCALE = 56


class StandardRoIHead(nn.Module):
    def __init__(self, bbox_head: nn.Module, num_classes: int = 80,
                 featmap_strides: Tuple[int, ...] = (4, 8, 16, 32),
                 bbox_roi_out: int = 7, mask_roi_out: int = 14,
                 target_means=(0., 0., 0., 0.),
                 target_stds=(0.1, 0.1, 0.2, 0.2), score_thr: float = 0.05,
                 nms_iou_thr: float = 0.5, max_per_img: int = 100):
        super().__init__()
        self.bbox_head = bbox_head
        self.num_classes = num_classes
        self.featmap_strides = tuple(featmap_strides)
        self.bbox_roi_out = bbox_roi_out
        self.mask_roi_out = mask_roi_out
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.score_thr = score_thr
        self.nms_iou_thr = nms_iou_thr
        self.max_per_img = max_per_img

    def _extract(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_batch: torch.Tensor, out_size: int) -> torch.Tensor:
        """(N, P, P, C) NHWC RoI features from the first
        ``len(featmap_strides)`` NCHW pyramid levels."""
        levels = [to_nhwc(f) for f in feats[:len(self.featmap_strides)]]
        return multilevel_roi_align(levels, rois, roi_batch, out_size,
                                    self.featmap_strides,
                                    sampling_ratio=ROI_SAMPLING_RATIO,
                                    finest_scale=FINEST_SCALE)

    def _bbox_forward(self, feats, rois, roi_batch):
        return self.bbox_head(self._extract(feats, rois, roi_batch,
                                            self.bbox_roi_out))

    def simple_test(self, feats, proposals: torch.Tensor,
                    proposal_valid: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Padded per-image detections + mask probabilities: dets
        (B, max_per_img, 5), labels and det_valid (B, max_per_img),
        mask_probs (B, max_per_img, s, s)."""
        with record_function('box_head_and_nms'):
            b, p = proposals.shape[:2]
            rois = proposals.reshape(b * p, 4)
            roi_batch = torch.arange(b, device=rois.device).repeat_interleave(
                p)
            cls_logits, bbox_deltas = self._bbox_forward(feats, rois,
                                                         roi_batch)
            cls_logits = cls_logits.reshape(b, p, -1)
            bbox_deltas = bbox_deltas.reshape(b, p, -1)
            outs = [bbox_head_get_dets(
                proposals[i], cls_logits[i], bbox_deltas[i],
                proposal_valid[i], batch['img_shape'][i],
                batch['scale_factor'][i], self.num_classes,
                self.target_means, self.target_stds, self.score_thr,
                self.nms_iou_thr, self.max_per_img, rescale=rescale)
                for i in range(b)]
            dets, labels, det_valid = (torch.stack([o[j] for o in outs])
                                       for j in range(3))
        result = {'dets': dets, 'labels': labels, 'det_valid': det_valid}
        routing: Dict[str, torch.Tensor] = {}
        with record_function('mask_branch'):
            result['mask_probs'] = self.simple_test_mask(
                feats, dets, labels, batch, rescale=rescale, routing=routing)
        if routing:
            result['msm_routing'] = routing
        return result

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        raise NotImplementedError
