"""The two-stage RoI head (port of ``dynamask_tpu/models/roi_head.py``:
``StandardRoIHead._sample_rois``, ``_extract``, ``_bbox_forward``,
``forward_train``, ``_pos_rois``, ``_mask_forward_train``, ``simple_test``
and ``simple_test_mask``, :167-331). RoI features come from the FPN-routed
RoIAlign (kernels K2 and, for the gradient, K4) with the static
``sampling_ratio`` 2, or with ``roi_extract_mode='generic_sum'`` /
``'generic_concat'`` (GRoIE's ``GenericRoIExtractor``) from every level
at once, summed or concatenated: one K2 launch (K4 in the backward) an
extract either way. The mode is the box extractor's and governs the mask
extract too, as in JAX (``roi_head.py:192``).

In training, each image's proposals (GT boxes put in front) are assigned
and sampled to a fixed ``num_samples`` slots, positives packed first; the
mask branch reads the first ``max_pos`` slots of each image. The mask
branch here is Mask R-CNN's: a 14x14 crop through the FCN mask head to
28x28 logits, each RoI's class channel; ``DynaMaskRoIHead`` overrides
it. With ``mask_head=None`` (Faster and Fast R-CNN) the head is the box
branch alone: box losses in training, boxes at inference.

The C4 detectors put a ``shared_head`` (``models/shared_head.py``, res5)
between each extract and its head, the box crop's and the mask crop's
alike (JAX ``roi_head.py:162, :213, :272, :326``). The DeformRoIPool
files extract the box crop with a ``bbox_roi_extractor`` module of their
own (``models/deform_roi_pool.py``: plain PyTorch, no kernel) in place of
RoIAlign (JAX ``bbox_extractor_obj``, :155-158)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..core.assigners import MaxIoUAssigner
from ..core.mask_targets import mask_targets_from_crops
from ..core.samplers import (RandomSampler, SamplingResult,
                             add_gt_as_proposals, stack_samples)
from ..ops.roi_align import generic_roi_align, multilevel_roi_align
from .bbox_head import (bbox_head_get_dets, bbox_head_loss,
                        bbox_targets_from_sample)
from .fcn_mask_head import fcn_mask_loss, select_class_channel
from .layers import to_nchw, to_nhwc


# the static sampling ratio of the JAX package (not the configs' adaptive 0)
# and the FPN routing scale of map_roi_levels
ROI_SAMPLING_RATIO = 2
FINEST_SCALE = 56


def image_draws(priorities, i: int):
    """Image ``i``'s row of each (B, N) draw of ``priorities``."""
    if priorities is None:
        return None
    if isinstance(priorities, dict):
        return {k: v[i] for k, v in priorities.items()}
    return priorities[i]


# the named draws of the typed samplers (``core/samplers.py``)
DRAW_NAMES = ('n', 'pos', 'pos_n', 'neg', 'neg_n')


def sampler_draws(noise: dict, key: str):
    """The sampler draws of ``noise`` under ``key``: ``noise[key]``, the
    sampler's own (B, N), and ``noise[key + '_' + name]`` for the named
    draws of a typed sampler; None where there are none."""
    draws = {name: noise[f'{key}_{name}'] for name in DRAW_NAMES
             if f'{key}_{name}' in noise}
    if key in noise:
        draws[''] = noise[key]
    return draws or None


class StandardRoIHead(nn.Module):
    # whether a training batch must carry ``gt_semantic`` (RefineMask's
    # heads say so)
    with_semantic = False
    # why the JAX package's ``aug_test`` cannot run this head (None: it
    # runs; ``check_aug_test``)
    aug_test_refusal: Optional[str] = None

    def __init__(self, bbox_head: nn.Module, mask_head: Optional[nn.Module],
                 num_classes: int = 80,
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
                 loss_bbox_weight: float = 1.0,
                 loss_mask_weight: float = 1.0,
                 smooth_l1_beta: Optional[float] = None,
                 reg_loss_type: Optional[str] = None,
                 reg_decoded_bbox: bool = False,
                 roi_extract_mode: str = 'single',
                 nms_cfg: Optional[dict] = None,
                 sampler: Optional[RandomSampler] = None,
                 shared_head: Optional[nn.Module] = None,
                 bbox_roi_extractor: Optional[nn.Module] = None):
        super().__init__()
        self.bbox_head = bbox_head
        self.mask_head = mask_head
        self.shared_head = shared_head
        self.bbox_roi_extractor = bbox_roi_extractor
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
        # a typed sampler (Libra's CombinedSampler, PISA's Score-HLR) or
        # the random one
        self.sampler = sampler or RandomSampler(num_samples, pos_fraction)
        self.max_pos = max_pos
        self.add_gt_as_proposals = add_gt_as_proposals
        self.loss_cls_weight = loss_cls_weight
        self.loss_bbox_weight = loss_bbox_weight
        self.loss_mask_weight = loss_mask_weight
        # None: the L1 box loss; a beta: SmoothL1 (the legacy v1 config);
        # reg_loss_type 'iou' / 'giou' / 'bounded_iou' on decoded boxes
        self.smooth_l1_beta = smooth_l1_beta
        self.reg_loss_type = reg_loss_type
        self.reg_decoded_bbox = reg_decoded_bbox
        if roi_extract_mode not in ('single', 'generic_sum',
                                    'generic_concat'):
            raise NotImplementedError(f'roi_extract_mode {roi_extract_mode}')
        self.roi_extract_mode = roi_extract_mode
        # multiclass_nms's nms_type / sigma / min_score (Soft-NMS)
        self.nms_cfg = dict(nms_cfg or {})

    def check_aug_test(self) -> None:
        """Raise ``NotImplementedError`` where the JAX package's
        ``aug_test`` (``dynamask_tpu/models/detectors.py:147-226``) raises
        on this head: it calls ``bbox_head`` on the raw box crop, so a
        head of stages, of two crops or without regression fails there,
        and so does a C4 head, whose box head reads the shared head's
        output. A DeformRoIPool head runs, its box crop RoIAlign's, as in
        JAX (ROADMAP.md queue 3, 3cc)."""
        why = self.aug_test_refusal
        if why is None and self.shared_head is not None:
            why = ('the C4 shared head: JAX\'s aug_test feeds the box head '
                   'the raw crop, without the shared head (a shape error '
                   'in flax)')
        if why is not None:
            raise NotImplementedError(
                f'{type(self).__name__}: no test-time augmentation, as in '
                f'the JAX package: {why}')

    def _extract(self, feats: Sequence[torch.Tensor], rois: torch.Tensor,
                 roi_batch: torch.Tensor, out_size: int) -> torch.Tensor:
        """(N, P, P, C) NHWC RoI features from the first
        ``len(featmap_strides)`` NCHW pyramid levels."""
        levels = [to_nhwc(f) for f in feats[:len(self.featmap_strides)]]
        if self.roi_extract_mode != 'single':
            return generic_roi_align(
                levels, rois, roi_batch, out_size, self.featmap_strides,
                sampling_ratio=ROI_SAMPLING_RATIO,
                aggregation=self.roi_extract_mode.split('_')[1])
        return multilevel_roi_align(levels, rois, roi_batch, out_size,
                                    self.featmap_strides,
                                    sampling_ratio=ROI_SAMPLING_RATIO,
                                    finest_scale=FINEST_SCALE)

    def _shared(self, crops: torch.Tensor) -> torch.Tensor:
        """(N, P, P, C) NHWC crops -> NCHW: through the shared head, where
        there is one."""
        x = to_nchw(crops)
        return x if self.shared_head is None else self.shared_head(x)

    def _bbox_forward(self, feats, rois, roi_batch):
        if self.bbox_roi_extractor is not None:
            crops = self.bbox_roi_extractor(
                [to_nhwc(f) for f in feats[:len(self.featmap_strides)]],
                rois, roi_batch)
        else:
            crops = self._extract(feats, rois, roi_batch, self.bbox_roi_out)
        if self.shared_head is None:
            return self.bbox_head(crops)
        return self.bbox_head(to_nhwc(self._shared(crops)))

    def _sample_rois(self, proposals, proposal_valid, batch,
                     priorities=None, generator=None, assigner=None,
                     add_gt: Optional[bool] = None) -> SamplingResult:
        """Per-image assign + sample -> a result with a leading batch dim;
        ``priorities`` (B, N) are the sampler's draws, or a dict of named
        (B, N) draws (``core/samplers.py``). ``assigner`` and
        ``add_gt`` (GTs put in front of the proposals) default to the
        head's."""
        assigner = assigner or self.assigner
        if add_gt is None:
            add_gt = self.add_gt_as_proposals
        samples = []
        for i in range(proposals.shape[0]):
            gts, gvalid = batch['gt_boxes'][i], batch['gt_valid'][i]
            boxes, valid = proposals[i], proposal_valid[i].bool()
            if add_gt:
                boxes, valid = add_gt_as_proposals(boxes, valid, gts, gvalid)
            assign = assigner(boxes, valid, gts, gvalid,
                              batch['gt_labels'][i])
            samples.append(self.sampler(
                assign, boxes, gts, image_draws(priorities, i), generator))
        return stack_samples(samples)

    def forward_train(self, feats, proposals: torch.Tensor,
                      proposal_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """Box-branch losses on the sampled RoIs, then the mask branch's on
        the packed positives. ``noise`` may hold the draws ('rcnn' (B, N)
        sampler priorities and a typed sampler's 'rcnn_<name>', 'gumbel'
        (B * max_pos, stages)); missing ones come from ``generator``."""
        noise = noise or {}
        with record_function('box_branch'):
            sample = self._sample_rois(proposals, proposal_valid, batch,
                                       sampler_draws(noise, 'rcnn'),
                                       generator)
            b, n = sample.boxes.shape[:2]
            rois = sample.boxes.reshape(b * n, 4)
            roi_batch = torch.arange(b, device=rois.device
                                     ).repeat_interleave(n)
            cls_logits, bbox_deltas = self._bbox_forward(feats, rois,
                                                         roi_batch)
            flat = SamplingResult(*[t.reshape((b * n,) + t.shape[2:])
                                    for t in sample])
            losses = self._box_loss(cls_logits, bbox_deltas, flat,
                                    self.target_stds,
                                    self.bbox_head.reg_class_agnostic)
        if self.mask_head is None:
            return losses
        with record_function('mask_branch'):
            losses.update(self._mask_forward_train(
                feats, sample, batch, self._mask_draws(noise), generator))
        return losses

    def _mask_draws(self, noise: dict):
        """The mask branch's draws in ``noise``: DynaMask's 'gumbel'
        uniforms (PointRend's heads take their points')."""
        return noise.get('gumbel')

    def _box_loss(self, cls_logits, bbox_deltas, flat: SamplingResult,
                  target_stds, reg_class_agnostic: bool):
        """The box head's losses on a flat sample, with the head's
        regression loss (decoded on the sample's RoIs under
        ``reg_decoded_bbox``)."""
        targets = bbox_targets_from_sample(
            flat, self.num_classes, self.target_means, target_stds,
            self.reg_decoded_bbox)
        return bbox_head_loss(
            cls_logits, bbox_deltas, targets, self.num_classes,
            self.loss_cls_weight, self.loss_bbox_weight, self.smooth_l1_beta,
            reg_class_agnostic, self.reg_loss_type, self.reg_decoded_bbox,
            flat.boxes, self.target_means, target_stds)

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
        """Mask R-CNN's mask loss on the ``max_pos`` positive slots: a
        ``mask_roi_out`` crop (K2; K4 in the backward), the mask head, and
        each RoI's targets at the logits' size from its GT's crop."""
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        logits = self.mask_head(self._shared(self._extract(
            feats, boxes, roi_batch, self.mask_roi_out)))
        targets = mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], logits.shape[-1])
        return {'loss_mask': fcn_mask_loss(logits, targets, labels, valid,
                                           self.loss_mask_weight)}

    def simple_test(self, feats, proposals: torch.Tensor,
                    proposal_valid: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Padded per-image detections + mask probabilities: dets
        (B, max_per_img, 5), labels and det_valid (B, max_per_img),
        mask_probs (B, max_per_img, s, s) (none without a mask head)."""
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
                self.nms_iou_thr, self.max_per_img, rescale=rescale,
                nms_cfg=self.nms_cfg)
                for i in range(b)]
            dets, labels, det_valid = (torch.stack([o[j] for o in outs])
                                       for j in range(3))
        result = {'dets': dets, 'labels': labels, 'det_valid': det_valid}
        if self.mask_head is None:
            return result
        routing: Dict[str, torch.Tensor] = {}
        with record_function('mask_branch'):
            result['mask_probs'] = self.simple_test_mask(
                feats, dets, labels, batch, rescale=rescale, routing=routing)
        if routing:
            result['msm_routing'] = routing
        return result

    def _rois(self, dets, batch, rescale):
        """The dets' boxes as (B * D, 4) RoIs at the input's scale, and
        their image indices."""
        b, d = dets.shape[:2]
        boxes = dets[..., :4]
        if rescale:  # back to input scale for RoI extraction
            boxes = boxes * batch['scale_factor'][:, None, :]
        roi_batch = torch.arange(b, device=dets.device).repeat_interleave(d)
        return boxes.reshape(b * d, 4), roi_batch

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        """(B, D, 2P, 2P) mask probabilities: each det's crop through the
        mask head, its class channel, a sigmoid."""
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        logits = self.mask_head(self._shared(self._extract(
            feats, rois, roi_batch, self.mask_roi_out)))
        probs = torch.sigmoid(select_class_channel(logits,
                                                   labels.reshape(b * d)))
        return probs.reshape(b, d, *probs.shape[1:])
