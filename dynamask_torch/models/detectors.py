"""The detectors (port of ``dynamask_tpu/models/detectors.py``: the
two-stage ``forward_train`` and ``simple_test`` :84-145 shared by
``MaskRCNN`` and ``FasterRCNN``, ``FastRCNN`` :242-280, ``RPN`` :283-378 and
``parse_losses`` :380): backbone -> FPN -> RPN proposals -> RoI head;
``FastRCNN`` takes its proposals from the batch, ``RPN`` stops at them.

Each stage is a named ``torch.profiler.record_function`` range, so a
profiler trace of the real entry splits its time: ``backbone``, ``fpn``,
then ``rpn_and_proposals``, ``box_head_and_nms`` and ``mask_branch`` at
inference, and ``rpn_loss``, ``proposals``, ``box_branch`` and
``mask_branch`` in ``forward_train``."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..core.assigners import MaxIoUAssigner
from ..core.bbox_transforms import delta2bbox
from ..core.merge_augs import (merge_aug_bboxes, merge_aug_masks,
                               recover_boxes, to_aug_frame)
from ..core.samplers import RandomSampler
from ..ops.nms import multiclass_nms
from ..utils.registry import DETECTORS
from .rpn_head import rpn_get_proposals, rpn_loss


def parse_losses(losses: Dict[str, torch.Tensor]):
    """total = the sum of every value whose key contains 'loss'; the log
    holds every value and the total."""
    total = sum(v for k, v in losses.items() if 'loss' in k)
    log = dict(losses)
    log['loss'] = total
    return total, log


class _Detector(nn.Module):
    """A backbone and its neck."""

    def __init__(self, backbone: nn.Module, neck: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.neck = neck

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def extract_feat(self, images: torch.Tensor):
        """NCHW images -> FPN levels P2..P6 (NCHW, ``channels_last``). A
        neck that ``takes_images`` (DetectoRS' RFP, which runs more
        backbone passes over them) is called with the images too, as JAX
        calls ``neck(images, feats)`` (``dynamask_tpu/models/detectors.py:
        61-68``), and opens its own ranges: ``fpn`` for its first pyramid,
        ``rfp_backbone`` (ASPP and the backbone pass) and ``rfp_neck``
        (pyramid and gate) for each round."""
        with record_function('backbone'):
            c = self.backbone(images)
        if getattr(self.neck, 'takes_images', False):
            return self.neck(images, c)
        with record_function('fpn'):
            return self.neck(c)

    @staticmethod
    def images(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """NHWC ``batch['image']`` -> NCHW in ``channels_last`` memory."""
        return batch['image'].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)


@DETECTORS.register_module()
class RPN(_Detector):
    """Backbone, neck and RPN head. As a detector of its own (JAX
    ``detectors.py:283-378``): ``forward_train`` is the RPN loss and
    ``simple_test`` returns the post-NMS proposals as class-0 dets
    (B, max_num, 5), score-ranked."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module,
                 anchor_scales: Tuple[float, ...] = (8,),
                 anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
                 anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_target_means=(0., 0., 0., 0.),
                 rpn_target_stds=(1., 1., 1., 1.),
                 rpn_nms_pre_test: int = 1000, rpn_max_num: int = 1000,
                 rpn_nms_thr: float = 0.7, rpn_nms_pre_train: int = 2000,
                 rpn_pos_iou_thr: float = 0.7, rpn_neg_iou_thr: float = 0.3,
                 rpn_min_pos_iou: float = 0.3, rpn_num_samples: int = 256,
                 rpn_pos_fraction: float = 0.5, rpn_cls_weight: float = 1.0,
                 rpn_bbox_weight: float = 1.0):
        super().__init__(backbone, neck)
        self.rpn_head = rpn_head
        self.anchor_generator = AnchorGenerator(anchor_strides, anchor_ratios,
                                                anchor_scales)
        self.rpn_target_means = tuple(rpn_target_means)
        self.rpn_target_stds = tuple(rpn_target_stds)
        self.rpn_nms_pre_test = rpn_nms_pre_test
        self.rpn_max_num = rpn_max_num
        self.rpn_nms_thr = rpn_nms_thr
        self.rpn_nms_pre_train = rpn_nms_pre_train
        self.rpn_assigner = MaxIoUAssigner(rpn_pos_iou_thr, rpn_neg_iou_thr,
                                           rpn_min_pos_iou,
                                           match_low_quality=True)
        self.rpn_sampler = RandomSampler(rpn_num_samples, rpn_pos_fraction)
        self.rpn_cls_weight = rpn_cls_weight
        self.rpn_bbox_weight = rpn_bbox_weight

    def rpn_train(self, feats, batch, noise, generator):
        """The RPN losses and, detached, the training proposals."""
        with record_function('rpn_loss'):
            cls_scores, bbox_preds = self.rpn_head(feats)
            sizes = [tuple(f.shape[-2:]) for f in feats]
            mlvl_anchors = self.anchor_generator.grid_anchors(
                sizes, feats[0].device)
            # anchors over the canvas padding take no part in the RPN
            # targets: validity from each image's un-padded extent
            anchor_valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            losses = rpn_loss(
                cls_scores, bbox_preds, torch.cat(mlvl_anchors), anchor_valid,
                batch['gt_boxes'], batch['gt_valid'], self.rpn_assigner,
                self.rpn_sampler, self.rpn_target_means, self.rpn_target_stds,
                self.rpn_cls_weight, self.rpn_bbox_weight,
                priorities=noise.get('rpn'), generator=generator)
        return losses, cls_scores, bbox_preds, mlvl_anchors

    def rpn_proposals(self, feats, batch):
        """The test-time proposals of ``feats``."""
        with record_function('rpn_and_proposals'):
            cls_scores, bbox_preds = self.rpn_head(feats)
            sizes = [tuple(f.shape[-2:]) for f in feats]
            anchors = self.anchor_generator.grid_anchors(sizes,
                                                         feats[0].device)
            return rpn_get_proposals(
                cls_scores, bbox_preds, anchors, batch['img_shape'],
                nms_pre=self.rpn_nms_pre_test, max_num=self.rpn_max_num,
                nms_thr=self.rpn_nms_thr, target_means=self.rpn_target_means,
                target_stds=self.rpn_target_stds)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The RPN losses of one padded batch; ``noise`` may hold the
        'rpn' (B, anchors) sampler priorities, else they come from
        ``generator``."""
        feats = self.extract_feat(self.images(batch))
        return self.rpn_train(feats, batch, noise or {}, generator)[0]

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Proposals as dets (B, max_num, 5) [x1, y1, x2, y2, score], in
        original-image coordinates with ``rescale``, labels 0 and
        det_valid."""
        props = self.rpn_proposals(self.extract_feat(self.images(batch)),
                                   batch)
        boxes = props.boxes
        if rescale:
            boxes = boxes / batch['scale_factor'][:, None, :].to(boxes.dtype)
        return {'dets': torch.cat([boxes, props.scores[..., None]], -1),
                'labels': torch.zeros(boxes.shape[:2], dtype=torch.int64,
                                      device=boxes.device),
                'det_valid': props.valid}


@DETECTORS.register_module()
class MaskRCNN(RPN):
    """The two-stage detector: the RPN's proposals through the RoI head."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, roi_head: nn.Module, **rpn_cfg):
        super().__init__(backbone, neck, rpn_head, **rpn_cfg)
        self.roi_head = roi_head

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The training losses of one padded batch (the JAX batch contract:
        ``image``, ``img_shape``, ``gt_boxes``, ``gt_labels``,
        ``gt_valid``, ``gt_crops``, ``gt_windows``). The random draws come
        from ``noise`` where it holds them ('rpn' (B, anchors) and 'rcnn'
        (B, candidates) sampler priorities, 'gumbel' (B * max_pos, stages)
        uniforms), else from ``generator``."""
        noise = noise or {}
        feats = self.extract_feat(self.images(batch))
        losses, cls_scores, bbox_preds, mlvl_anchors = self.rpn_train(
            feats, batch, noise, generator)
        with record_function('proposals'), torch.no_grad():
            proposals = rpn_get_proposals(
                [c.detach() for c in cls_scores],
                [p.detach() for p in bbox_preds], mlvl_anchors,
                batch['img_shape'], nms_pre=self.rpn_nms_pre_train,
                max_num=self.rpn_max_num, nms_thr=self.rpn_nms_thr,
                target_means=self.rpn_target_means,
                target_stds=self.rpn_target_stds)
        losses.update(self.roi_head.forward_train(
            feats, proposals.boxes, proposals.valid, batch, noise, generator))
        return losses

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """``batch['image']`` (B, H, W, 3) NHWC as in the JAX package,
        ``img_shape`` (B, 2), ``scale_factor`` (B, 4). Returns dets
        (B, 100, 5), labels, det_valid and, with a mask head, mask_probs
        (B, 100, s, s) in fixed slots."""
        feats = self.extract_feat(self.images(batch))
        proposals = self.rpn_proposals(feats, batch)
        return self.roi_head.simple_test(feats, proposals.boxes,
                                         proposals.valid, batch,
                                         rescale=rescale)

    @torch.no_grad()
    def aug_test(self, batches: Sequence[Dict[str, torch.Tensor]],
                 flips: Sequence[bool]) -> Dict[str, torch.Tensor]:
        """Test-time augmentation (JAX ``TwoStageDetector.aug_test``,
        ``dynamask_tpu/models/detectors.py:147-226``): ``batches`` are one
        batch per augmentation, each image resized (and, where
        ``flips[i]``, flipped in its resized region) on its canvas.

        The proposals come from the first augmentation alone (3bz),
        recovered to original coordinates and mapped into each
        augmentation's frame. Each augmentation runs its own backbone and
        FPN and the box branch over all of them (its extract and box
        head; the boxes not clipped, 3ca); its boxes are recovered, its
        softmax scores averaged. One ``multiclass_nms`` an image (greedy,
        whatever the config's ``nms``, 3cb) runs over the merged boxes
        with the first augmentation's validity. The mask branch runs in
        each frame on the merged dets mapped there (``simple_test_mask(...,
        rescale=False)``), and the probabilities average after the flip
        back. Returns what ``simple_test`` returns, in original-image
        coordinates. The labels are JAX's departures from mmdet, kept
        (ROADMAP.md queue 3)."""
        rh = self.roi_head
        rh.check_aug_test()
        b0 = batches[0]
        feats0 = self.extract_feat(self.images(b0))
        props = self.rpn_proposals(feats0, b0)

        def frame(batch):
            return batch['img_shape'][:, None], batch['scale_factor'][:, None]

        ori = recover_boxes(props.boxes, *frame(b0), flips[0])
        bsz, p = ori.shape[:2]
        aug_boxes, aug_scores, feats_list = [], [], []
        with record_function('box_head_and_nms'):
            for ai, (batch, flip) in enumerate(zip(batches, flips)):
                feats = feats0 if ai == 0 else self.extract_feat(
                    self.images(batch))
                feats_list.append(feats)
                rois = to_aug_frame(ori, *frame(batch), flip).reshape(
                    bsz * p, 4)
                roi_batch = torch.arange(
                    bsz, device=rois.device).repeat_interleave(p)
                cls, deltas = rh.bbox_head(rh._extract(feats, rois, roi_batch,
                                                       rh.bbox_roi_out))
                boxes = delta2bbox(rois, deltas.float(), rh.target_means,
                                   rh.target_stds).reshape(bsz, p, -1, 4)
                aug_boxes.append(recover_boxes(
                    boxes.reshape(bsz, -1, 4), *frame(batch), flip
                ).reshape(bsz, p, -1, 4))
                aug_scores.append(torch.softmax(cls.float(), -1).reshape(
                    bsz, p, -1))
            boxes, scores = merge_aug_bboxes(aug_boxes, aug_scores)
            outs = [multiclass_nms(
                boxes[i].reshape(p, -1), scores[i, :, :rh.num_classes],
                rh.score_thr, rh.nms_iou_thr, rh.max_per_img,
                valid=props.valid[i]) for i in range(bsz)]
            dets, labels, det_valid = (torch.stack([o[j] for o in outs])
                                       for j in range(3))
        result = {'dets': dets, 'labels': labels, 'det_valid': det_valid}
        if rh.mask_head is None:
            return result
        with record_function('mask_branch'):
            aug_masks = []
            for feats, batch, flip in zip(feats_list, batches, flips):
                aug_dets = torch.cat([to_aug_frame(
                    dets[..., :4], *frame(batch), flip), dets[..., 4:]], -1)
                aug_masks.append(rh.simple_test_mask(
                    feats, aug_dets, labels, batch, rescale=False).float())
            result['mask_probs'] = merge_aug_masks(aug_masks, flips)
        return result


@DETECTORS.register_module()
class FasterRCNN(MaskRCNN):
    """The two-stage detector of a box-only RoI head (``mask_head=None``)."""


@DETECTORS.register_module()
class FastRCNN(_Detector):
    """The RoI head over the batch's precomputed proposals, no RPN (JAX
    ``detectors.py:242-280``): ``proposals`` (B, P, 4) at the input's scale
    and ``proposal_valid`` (B, P), from the dataset's ``proposal_file``
    through ``LoadProposals``."""

    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 roi_head: nn.Module):
        super().__init__(backbone, neck)
        self.roi_head = roi_head

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The RoI head's losses; ``noise`` may hold the 'rcnn' (B, GTs +
        P) sampler priorities."""
        feats = self.extract_feat(self.images(batch))
        return self.roi_head.forward_train(
            feats, batch['proposals'], batch['proposal_valid'], batch,
            noise or {}, generator)

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        feats = self.extract_feat(self.images(batch))
        return self.roi_head.simple_test(feats, batch['proposals'],
                                         batch['proposal_valid'], batch,
                                         rescale=rescale)
