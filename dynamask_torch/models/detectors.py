"""Two-stage detector at inference (port of ``MaskRCNN.simple_test``,
``dynamask_tpu/models/detectors.py:131-145``): backbone -> FPN -> RPN
proposals -> RoI head. Each stage of ``simple_test`` is a named
``torch.profiler.record_function`` range (``backbone``, ``fpn``,
``rpn_and_proposals``, then the RoI head's ``box_head_and_nms`` and
``mask_branch``), so a profiler trace of the real entry splits its time."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from ..core.anchors import AnchorGenerator
from ..utils.registry import DETECTORS
from .rpn_head import rpn_get_proposals


@DETECTORS.register_module()
class MaskRCNN(nn.Module):
    def __init__(self, backbone: nn.Module, neck: nn.Module,
                 rpn_head: nn.Module, roi_head: nn.Module,
                 anchor_scales: Tuple[float, ...] = (8,),
                 anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0),
                 anchor_strides: Tuple[int, ...] = (4, 8, 16, 32, 64),
                 rpn_target_means=(0., 0., 0., 0.),
                 rpn_target_stds=(1., 1., 1., 1.),
                 rpn_nms_pre_test: int = 1000, rpn_max_num: int = 1000,
                 rpn_nms_thr: float = 0.7):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.rpn_head = rpn_head
        self.roi_head = roi_head
        self.anchor_generator = AnchorGenerator(anchor_strides, anchor_ratios,
                                                anchor_scales)
        self.rpn_target_means = tuple(rpn_target_means)
        self.rpn_target_stds = tuple(rpn_target_stds)
        self.rpn_nms_pre_test = rpn_nms_pre_test
        self.rpn_max_num = rpn_max_num
        self.rpn_nms_thr = rpn_nms_thr

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def extract_feat(self, images: torch.Tensor):
        """NCHW images -> FPN levels P2..P6 (NCHW, ``channels_last``)."""
        with record_function('backbone'):
            c = self.backbone(images)
        with record_function('fpn'):
            return self.neck(c)

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """``batch['image']`` (B, H, W, 3) NHWC as in the JAX package,
        ``img_shape`` (B, 2), ``scale_factor`` (B, 4). Returns dets
        (B, 100, 5), labels, det_valid and mask_probs (B, 100, 112, 112)
        in fixed slots."""
        images = batch['image'].permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        feats = self.extract_feat(images)
        with record_function('rpn_and_proposals'):
            cls_scores, bbox_preds = self.rpn_head(feats)
            sizes = [tuple(f.shape[-2:]) for f in feats]
            anchors = self.anchor_generator.grid_anchors(sizes, images.device)
            proposals = rpn_get_proposals(
                cls_scores, bbox_preds, anchors, batch['img_shape'],
                nms_pre=self.rpn_nms_pre_test, max_num=self.rpn_max_num,
                nms_thr=self.rpn_nms_thr, target_means=self.rpn_target_means,
                target_stds=self.rpn_target_stds)
        return self.roi_head.simple_test(feats, proposals.boxes,
                                         proposals.valid, batch,
                                         rescale=rescale)
