"""Hybrid Task Cascade (port of ``dynamask_tpu/models/htc.py:43-383``:
``FusedSemanticHead``, ``semantic_seg_loss``, ``HTCMaskHead`` and
``HybridTaskCascadeRoIHead``).

On top of Cascade R-CNN:

* a semantic branch, ``FusedSemanticHead``: 1×1 laterals (ReLU) of every
  pyramid level, resized to the fusion level (bilinear,
  ``align_corners=True``) and summed, four 3×3 convs, then class logits
  and a ReLU embedding. A single-level RoIAlign crop of the embedding at
  ``1 / semantic_out_stride`` (``sampling_ratio`` 1, the JAX package's
  ``simple_roi_align``) is added to the box features (at 7²) and to the
  mask features (at 14²): one more K2 launch per extract, and K4 takes
  its gradient into the semantic branch;
* one ``HTCMaskHead`` a stage, with mask information flow: the heads
  before stage s run for their features only, each passed through the
  next head's ``conv_res`` (1×1, ReLU) and added to its input;
* interleaved training: each stage's mask branch re-assigns and
  re-samples on the boxes that stage's box head refined (the configs'
  ``interleaved=True``; the builder refuses the other options' values
  no config uses: ``interleaved``, ``mask_info_flow`` False, a
  ``semantic_fusion`` other than both branches).

At test time the stages' plain sigmoids are averaged and each det's class
channel taken. Where the JAX package parts from mmdet the port follows it
(ROADMAP.md queue 3): the box loss is L1 whatever the config names (3l),
only stage 0 adds the GTs as proposals (3n), the laterals are resized
after their conv and ReLU and the box branch's semantic crop is taken at
7² directly (3r).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.boundary import interpolate_bilinear
from ..core.mask_targets import mask_targets_from_crops
from ..ops.roi_align import simple_roi_align
from ..utils.registry import HEADS
from .cascade_roi_head import CascadeRoIHead, stage_draws
from .fcn_mask_head import FCNMaskHead, fcn_mask_loss, select_class_channel
from .layers import ConvModule, to_nchw, to_nhwc


@HEADS.register_module()
class FusedSemanticHead(nn.Module):
    """mmdet's names: ``lateral_convs.i.conv``, ``convs.i.conv``,
    ``conv_embedding.conv``, ``conv_logits``."""

    def __init__(self, num_ins: int = 5, fusion_level: int = 1,
                 num_convs: int = 4, in_channels: int = 256,
                 conv_out_channels: int = 256, num_classes: int = 183):
        super().__init__()
        self.num_ins = num_ins
        self.fusion_level = fusion_level
        self.num_classes = num_classes
        self.lateral_convs = nn.ModuleList(
            ConvModule(in_channels, in_channels, 1) for _ in range(num_ins))
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, padding=1)
            for i in range(num_convs))
        self.conv_embedding = ConvModule(conv_out_channels, conv_out_channels,
                                         1)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        """NCHW pyramid levels -> (logits (B, num_classes, h, w),
        embedding (B, C, h, w)) at the fusion level's size."""
        if len(feats) != self.num_ins:
            raise ValueError(f'FusedSemanticHead: {len(feats)} levels, '
                             f'num_ins {self.num_ins}')
        fl = self.fusion_level
        x = F.relu(self.lateral_convs[fl](feats[fl]))
        fh, fw = x.shape[-2:]
        for i, feat in enumerate(feats):
            if i != fl:
                lat = F.relu(self.lateral_convs[i](feat))
                x = x + interpolate_bilinear(lat, fh, fw, align_corners=True)
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.conv_logits(x), F.relu(self.conv_embedding(x))


def semantic_seg_loss(seg_logits: torch.Tensor, labels: torch.Tensor,
                      loss_weight: float = 0.2,
                      ignore_label: int = 255) -> torch.Tensor:
    """Pixel cross-entropy of (B, K, h, w) logits against (B, h, w)
    labels, averaged over the pixels whose label is a class (not
    ``ignore_label``), times ``loss_weight``."""
    logits = seg_logits.float()
    k = logits.shape[1]
    labels = labels.long()
    valid = (labels != ignore_label) & (labels >= 0) & (labels < k)
    logp = F.log_softmax(logits, 1)
    ll = logp.gather(1, labels.clamp(0, k - 1)[:, None])[:, 0]
    return loss_weight * (-(ll * valid).sum() /
                          valid.sum().float().clamp(min=1.0))


@HEADS.register_module()
class HTCMaskHead(FCNMaskHead):
    """``FCNMaskHead`` + ``conv_res`` (``with_conv_res``; stage 0 has
    none): the previous stage's features through a 1×1 conv and a ReLU,
    added to the input before the convs."""

    def __init__(self, with_conv_res: bool = True, **kw):
        super().__init__(**kw)
        self.with_conv_res = with_conv_res
        if with_conv_res:
            c = self.upsample.in_channels
            self.conv_res = ConvModule(c, c, 1)

    def forward(self, x: torch.Tensor, res_feat: Optional[torch.Tensor] = None,
                return_logits: bool = True, return_feat: bool = True):
        """(N, C, P, P) RoI features [and the previous head's features] ->
        logits (N, classes, 2P, 2P) and/or the features after the
        convs."""
        if res_feat is not None:
            if not self.with_conv_res:
                raise ValueError('HTCMaskHead without conv_res given '
                                 'res_feat')
            x = x + F.relu(self.conv_res(res_feat))
        for conv in self.convs:
            x = F.relu(conv(x))
        outs = []
        if return_logits:
            outs.append(self.conv_logits(F.relu(self.upsample(x))))
        if return_feat:
            outs.append(x)
        return tuple(outs) if len(outs) > 1 else outs[0]


@HEADS.register_module()
class HybridTaskCascadeRoIHead(CascadeRoIHead):
    """``mask_head`` is the sequence of stage ``HTCMaskHead``s;
    ``semantic_head`` a ``FusedSemanticHead`` or None (HTC without
    semantic)."""

    def __init__(self, bbox_head: Sequence[nn.Module],
                 mask_head: Sequence[nn.Module],
                 semantic_head: Optional[FusedSemanticHead] = None,
                 semantic_out_stride: int = 8,
                 semantic_loss_weight: float = 0.2, mask_size: int = 28,
                 **kw):
        super().__init__(bbox_head, nn.ModuleList(mask_head), **kw)
        self.semantic_head = semantic_head
        self.semantic_out_stride = semantic_out_stride
        self.semantic_loss_weight = semantic_loss_weight
        self.mask_size = mask_size

    # -- features -------------------------------------------------------------

    def _semantic(self, feats):
        """(segmentation logits, NHWC embedding), or Nones without a
        semantic branch."""
        if self.semantic_head is None:
            return None, None
        with record_function('semantic_branch'):
            seg_logits, embedding = self.semantic_head(feats)
        return seg_logits, to_nhwc(embedding)

    def _sem_crop(self, sem_feat, rois, roi_batch, out_size):
        return simple_roi_align(sem_feat, rois, roi_batch, out_size,
                                1.0 / self.semantic_out_stride)

    def _bbox_feats(self, feats, rois, roi_batch, sem_feat=None):
        bf = self._extract(feats, rois, roi_batch, self.bbox_roi_out)
        if sem_feat is not None:
            bf = bf + self._sem_crop(sem_feat, rois, roi_batch,
                                     self.bbox_roi_out)
        return bf

    def _mask_feats(self, feats, rois, roi_batch, sem_feat=None):
        mf = self._extract(feats, rois, roi_batch, self.mask_roi_out)
        if sem_feat is not None:
            mf = mf + self._sem_crop(sem_feat, rois, roi_batch,
                                     self.mask_roi_out)
        return to_nchw(mf)

    # -- training -------------------------------------------------------------

    def forward_train(self, feats, proposals: torch.Tensor,
                      proposal_valid: torch.Tensor,
                      batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """``loss_semantic_seg`` where the batch holds ``gt_semantic_seg``
        ((B, h, w) labels at the fusion level's size) and the head has a
        semantic branch; each stage's box losses and its mask loss
        ``s{i}.loss_mask``, weighted by the stage's weight. ``noise`` may
        hold each stage's box and mask-resample priorities
        (:func:`~dynamask_torch.models.cascade_roi_head.stage_draws`);
        missing ones come from ``generator``."""
        noise = noise or {}
        losses: Dict[str, torch.Tensor] = {}
        seg_logits, sem_feat = self._semantic(feats)
        if seg_logits is not None and 'gt_semantic_seg' in batch:
            losses['loss_semantic_seg'] = semantic_seg_loss(
                seg_logits, batch['gt_semantic_seg'],
                self.semantic_loss_weight)
        cur, cur_valid = proposals, proposal_valid
        for stage in range(self.num_stages):
            with record_function('box_branch'):
                sample = self._sample_stage(stage, cur, cur_valid, batch,
                                            stage_draws(noise, stage),
                                            generator)
                sl, rois, cls_logits, deltas = self._box_stage(
                    stage, feats, sample, sem_feat)
                losses.update(sl)
                refined = self._refine(stage, rois, cls_logits, deltas,
                                       batch['img_shape'])
            with record_function('mask_branch'):
                msample = self._sample_stage(
                    stage, refined, sample.valid, batch,
                    stage_draws(noise, stage, mask=True), generator)
                losses[f's{stage}.loss_mask'] = self._htc_mask_loss(
                    stage, feats, msample, batch, sem_feat)
            cur, cur_valid = refined, sample.valid
        return losses

    def _htc_mask_loss(self, stage, feats, sample, batch, sem_feat):
        """Stage ``stage``'s weighted mask loss on the packed positives:
        heads 0..stage-1 run for their features only (information
        flow), then head ``stage``'s logits."""
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        mf = self._mask_feats(feats, boxes, roi_batch, sem_feat)
        last = None
        for i in range(stage):
            last = self.mask_head[i](mf, last, return_logits=False)
        logits = self.mask_head[stage](mf, last, return_feat=False)
        targets = mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], self.mask_size)
        return self.stage_loss_weights[stage] * fcn_mask_loss(
            logits, targets, labels, valid, self.loss_mask_weight)

    # -- test -----------------------------------------------------------------

    def simple_test(self, feats, proposals: torch.Tensor,
                    proposal_valid: torch.Tensor,
                    batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        _, sem_feat = self._semantic(feats)
        with record_function('box_head_and_nms'):
            dets, labels, det_valid = self._cascade_dets(
                feats, proposals, proposal_valid, batch, rescale, sem_feat)
        result = {'dets': dets, 'labels': labels, 'det_valid': det_valid}
        with record_function('mask_branch'):
            result['mask_probs'] = self._htc_test_mask(
                feats, dets, labels, batch, sem_feat, rescale)
        return result

    def _htc_test_mask(self, feats, dets, labels, batch, sem_feat, rescale):
        """(B, D, 2P, 2P): one mask extract, every stage's head with the
        information flow, the mean of their sigmoids, each det's class
        channel (JAX ``htc.py:360-382``: the plain per-stage sigmoids,
        not the cumulative form)."""
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        mf = self._mask_feats(feats, rois, roi_batch, sem_feat)
        last, probs = None, 0.0
        for head in self.mask_head:
            logits, last = head(mf, last)
            probs = probs + torch.sigmoid(logits.float())
        probs = select_class_channel(probs / len(self.mask_head),
                                     labels.reshape(b * d))
        return probs.reshape(b, d, *probs.shape[1:])
