"""Box branch of the two-stage RoI head (port of
``dynamask_tpu/models/roi_head.py``: ``StandardRoIHead._sample_rois``,
``_extract``, ``_bbox_forward``, ``forward_train``, ``_pos_rois`` and
``simple_test``, :167-316). RoI features come from the FPN-routed RoIAlign
(kernels K2 and, for the gradient, K4) with the static ``sampling_ratio`` 2.

In training, each image's proposals (GT boxes put in front) are assigned
and sampled to a fixed ``num_samples`` slots, positives packed first; the
mask branch reads the first ``max_pos`` slots of each image."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..core.assigners import MaxIoUAssigner
from ..core.samplers import (RandomSampler, SamplingResult,
                             add_gt_as_proposals, stack_samples)
from ..ops.roi_align import multilevel_roi_align
from .bbox_head import (bbox_head_get_dets, bbox_head_loss,
                        bbox_targets_from_sample)
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
                 nms_iou_thr: float = 0.5, max_per_img: int = 100,
                 num_samples: int = 512, pos_fraction: float = 0.25,
                 max_pos: int = 128, add_gt_as_proposals: bool = True,
                 pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.5,
                 min_pos_iou: float = 0.5, match_low_quality: bool = True,
                 loss_cls_weight: float = 1.0,
                 loss_bbox_weight: float = 1.0):
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
        self.assigner = MaxIoUAssigner(pos_iou_thr, neg_iou_thr, min_pos_iou,
                                       match_low_quality=match_low_quality)
        self.sampler = RandomSampler(num_samples, pos_fraction)
        self.max_pos = max_pos
        self.add_gt_as_proposals = add_gt_as_proposals
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight

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

    def _sample_rois(self, proposals, proposal_valid, batch,
                     priorities=None, generator=None) -> SamplingResult:
        """Per-image assign + sample -> a result with a leading batch dim;
        ``priorities`` (B, N) are the sampler's draws."""
        samples = []
        for i in range(proposals.shape[0]):
            gts, gvalid = batch['gt_boxes'][i], batch['gt_valid'][i]
            boxes, valid = proposals[i], proposal_valid[i].bool()
            if self.add_gt_as_proposals:
                boxes, valid = add_gt_as_proposals(boxes, valid, gts, gvalid)
            assign = self.assigner(boxes, valid, gts, gvalid,
                                   batch['gt_labels'][i])
            samples.append(self.sampler(
                assign, boxes, gts,
                None if priorities is None else priorities[i], generator))
        return stack_samples(samples)

    def forward_train(self, feats, proposals: torch.Tensor,
                      proposal_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """Box-branch losses on the sampled RoIs, then the mask branch's on
        the packed positives. ``noise`` may hold the draws ('rcnn' (B, N)
        sampler priorities, 'gumbel' (B * max_pos, stages)); missing ones
        come from ``generator``."""
        noise = noise or {}
        with record_function('box_branch'):
            sample = self._sample_rois(proposals, proposal_valid, batch,
                                       noise.get('rcnn'), generator)
            b, n = sample.boxes.shape[:2]
            rois = sample.boxes.reshape(b * n, 4)
            roi_batch = torch.arange(b, device=rois.device
                                     ).repeat_interleave(n)
            cls_logits, bbox_deltas = self._bbox_forward(feats, rois,
                                                         roi_batch)
            flat = SamplingResult(*[t.reshape((b * n,) + t.shape[2:])
                                    for t in sample])
            targets = bbox_targets_from_sample(
                flat, self.num_classes, self.target_means, self.target_stds)
            losses = bbox_head_loss(cls_logits, bbox_deltas, targets,
                                    self.num_classes, self.loss_cls_weight,
                                    self.loss_bbox_weight)
        with record_function('mask_branch'):
            losses.update(self._mask_forward_train(
                feats, sample, batch, noise.get('gumbel'), generator))
        return losses

    def _pos_rois(self, sample: SamplingResult):
        """The first ``max_pos`` slots of each image (the packed
        positives): boxes, validity, labels, GT index, image index."""
        b, k = sample.boxes.shape[0], self.max_pos
        boxes = sample.boxes[:, :k].reshape(b * k, 4)
        valid = (sample.is_pos[:, :k] & sample.valid[:, :k]).reshape(b * k)
        labels = sample.labels[:, :k].reshape(b * k)
        gt = sample.gt_inds[:, :k].reshape(b * k)
        roi_batch = torch.arange(b, device=boxes.device).repeat_interleave(k)
        return boxes, valid, labels, gt, roi_batch

    def _mask_forward_train(self, feats, sample, batch, gumbel_u=None,
                            generator=None):
        raise NotImplementedError

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
