"""Cascade R-CNN's RoI head (port of ``CascadeRoIHead``,
``dynamask_tpu/models/cascade_roi_head.py:31-200``).

``num_stages`` box heads with rising IoU thresholds and shrinking delta
stds. In training each stage assigns (``MaxIoUAssigner`` with
``pos = neg = min_pos = thr``, no low-quality matches) and samples its
fixed ``num_samples`` slots on the boxes the previous stage refined:
its deltas, detached, decoded (the argmax class's for a class-specific
head) and clipped to the image. Only stage 0 puts the GTs in front of its
proposals, as the JAX package does (ROADMAP.md queue 3, 3n). At test
time the stages' softmaxes are averaged, the boxes come from the last
stage, and one multiclass NMS gives the dets. Cascade Mask R-CNN has one
``FCNMaskHead``, trained on the last stage's sample at weight 1 and run
once on the dets (JAX's form; mmdet repeats it per stage, 3m).

Each stage's box extract is one multilevel RoIAlign (kernel K2; K4 in
the backward), so a forward runs ``num_stages`` box crops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.assigners import MaxIoUAssigner
from ..core.bbox_transforms import clip_boxes, delta2bbox
from ..core.samplers import SamplingResult
from ..ops.nms import multiclass_nms
from ..utils.registry import HEADS
from .roi_head import StandardRoIHead


def stage_draws(noise: dict, stage: int, mask: bool = False):
    """The sampler priorities of one draw in ``noise``: stage 0's box
    sample reads 'rcnn' (as the standard head does), stage s's 'rcnn_s',
    HTC's mask resample of stage s 'rcnn_mask_s'; None where absent."""
    if mask:
        return noise.get(f'rcnn_mask_{stage}')
    return noise.get('rcnn' if stage == 0 else f'rcnn_{stage}')


@HEADS.register_module()
class CascadeRoIHead(StandardRoIHead):
    """``bbox_head`` is the sequence of stage heads; the head's other
    options (sampler, extractors, test NMS, stage 0's target stds) are
    the standard head's."""

    aug_test_refusal = ('its box head is a tuple of stage heads, which '
                        'JAX\'s aug_test calls as one (a TypeError)')

    def __init__(self, bbox_head: Sequence[nn.Module],
                 mask_head: Optional[nn.Module],
                 stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25),
                 stage_pos_iou_thr: Tuple[float, ...] = (0.5, 0.6, 0.7),
                 stage_target_stds: Tuple[Tuple[float, ...], ...] = (
                     (0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
                     (0.033, 0.033, 0.067, 0.067)), **common):
        super().__init__(nn.ModuleList(bbox_head), mask_head, **common)
        self.num_stages = len(self.bbox_head)
        self.stage_loss_weights = tuple(stage_loss_weights)
        self.stage_target_stds = tuple(tuple(s) for s in stage_target_stds)
        self.stage_assigners = [
            MaxIoUAssigner(thr, thr, thr, match_low_quality=False)
            for thr in stage_pos_iou_thr]

    def _bbox_feats(self, feats, rois, roi_batch, sem_feat=None):
        """The box features of ``rois`` (HTC adds its semantic crop)."""
        return self._extract(feats, rois, roi_batch, self.bbox_roi_out)

    # -- the stages ---------------------------------------------------------

    def _sample_stage(self, stage: int, proposals, proposal_valid, batch,
                      priorities=None, generator=None) -> SamplingResult:
        """Stage ``stage``'s assignment and sample; the GTs join the
        candidates at stage 0 only (3n)."""
        return self._sample_rois(
            proposals, proposal_valid, batch, priorities, generator,
            assigner=self.stage_assigners[stage],
            add_gt=stage == 0 and self.add_gt_as_proposals)

    def _refine(self, stage: int, rois, cls_logits, bbox_deltas,
                img_shape) -> torch.Tensor:
        """(B, N, 4) boxes decoded from stage ``stage``'s detached deltas
        on its (B * N, 4) ``rois`` (the argmax foreground class's deltas
        for a class-specific head), clipped to each image."""
        deltas = bbox_deltas.detach()
        if not self.bbox_head[stage].reg_class_agnostic:
            labels = cls_logits.detach()[:, :-1].argmax(-1)
            deltas = deltas.reshape(-1, self.num_classes, 4)[
                torch.arange(deltas.shape[0], device=deltas.device), labels]
        boxes = delta2bbox(rois, deltas, self.target_means,
                           self.stage_target_stds[stage])
        b = img_shape.shape[0]
        return clip_boxes(boxes.reshape(b, -1, 4), img_shape[:, None, :])

    def _box_stage(self, stage: int, feats, sample: SamplingResult,
                   sem_feat=None):
        """Stage ``stage``'s head on its sample -> (its weighted losses,
        the sampled RoIs (B * N, 4), class logits, deltas)."""
        b, n = sample.boxes.shape[:2]
        rois = sample.boxes.reshape(b * n, 4)
        roi_batch = torch.arange(b, device=rois.device).repeat_interleave(n)
        head = self.bbox_head[stage]
        cls_logits, bbox_deltas = head(self._bbox_feats(feats, rois,
                                                        roi_batch, sem_feat))
        flat = SamplingResult(*[t.reshape((b * n,) + t.shape[2:])
                                for t in sample])
        sl = self._box_loss(cls_logits, bbox_deltas, flat,
                            self.stage_target_stds[stage],
                            head.reg_class_agnostic)
        w = self.stage_loss_weights[stage]
        losses = {f's{stage}.loss_cls': w * sl['loss_cls'],
                  f's{stage}.loss_bbox': w * sl['loss_bbox'],
                  f's{stage}.acc': sl['acc']}
        return losses, rois, cls_logits, bbox_deltas

    def forward_train(self, feats, proposals: torch.Tensor,
                      proposal_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """Each stage's losses (``s{i}.loss_cls``, ``s{i}.loss_bbox``,
        ``s{i}.acc``), then the mask head's ``loss_mask`` on the last
        stage's sample. ``noise`` may hold each stage's sampler priorities
        (:func:`stage_draws`); missing ones come from ``generator``."""
        noise = noise or {}
        losses: Dict[str, torch.Tensor] = {}
        cur, cur_valid = proposals, proposal_valid
        for stage in range(self.num_stages):
            with record_function('box_branch'):
                sample = self._sample_stage(stage, cur, cur_valid, batch,
                                            stage_draws(noise, stage),
                                            generator)
                sl, rois, cls_logits, deltas = self._box_stage(
                    stage, feats, sample)
                losses.update(sl)
                if stage < self.num_stages - 1:
                    cur = self._refine(stage, rois, cls_logits, deltas,
                                       batch['img_shape'])
                    cur_valid = sample.valid
        if self.mask_head is not None:
            with record_function('mask_branch'):
                losses.update(self._mask_forward_train(feats, sample, batch))
        return losses

    def _cascade_dets(self, feats, proposals, proposal_valid, batch,
                      rescale: bool, sem_feat=None):
        """The stages over the proposals, the averaged scores, the last
        stage's boxes and one multiclass NMS an image -> dets (B, D, 5),
        labels, det_valid."""
        b, p = proposals.shape[:2]
        rois = proposals.reshape(b * p, 4)
        roi_batch = torch.arange(b, device=rois.device).repeat_interleave(p)
        score_sum = 0.0
        for stage in range(self.num_stages):
            cls_logits, bbox_deltas = self.bbox_head[stage](
                self._bbox_feats(feats, rois, roi_batch, sem_feat))
            cls_logits, bbox_deltas = cls_logits.float(), bbox_deltas.float()
            score_sum = score_sum + F.softmax(cls_logits, -1)
            if stage < self.num_stages - 1:
                rois = self._refine(stage, rois, cls_logits, bbox_deltas,
                                    batch['img_shape']).reshape(-1, 4)
        scores = (score_sum / self.num_stages)[:, :self.num_classes]
        boxes = delta2bbox(rois, bbox_deltas, self.target_means,
                           self.stage_target_stds[-1]).reshape(b, p, -1, 4)
        boxes = clip_boxes(boxes, batch['img_shape'][:, None, None, :])
        if rescale:
            boxes = boxes / batch['scale_factor'][:, None, None, :].to(
                boxes.dtype)
        scores = scores.reshape(b, p, -1)
        outs = [multiclass_nms(boxes[i].reshape(p, -1), scores[i],
                               self.score_thr, self.nms_iou_thr,
                               self.max_per_img, valid=proposal_valid[i],
                               **self.nms_cfg)
                for i in range(b)]
        return (torch.stack([o[j] for o in outs]) for j in range(3))

    def simple_test(self, feats, proposals: torch.Tensor,
                    proposal_valid: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Padded dets (B, max_per_img, 5), labels, det_valid and, with a
        mask head, mask_probs (B, max_per_img, 2P, 2P)."""
        with record_function('box_head_and_nms'):
            dets, labels, det_valid = self._cascade_dets(
                feats, proposals, proposal_valid, batch, rescale)
        result = {'dets': dets, 'labels': labels, 'det_valid': det_valid}
        if self.mask_head is not None:
            with record_function('mask_branch'):
                result['mask_probs'] = self.simple_test_mask(
                    feats, dets, labels, batch, rescale=rescale)
        return result
