"""The RefineMask family (port of ``dynamask_tpu/models/refine_mask_head.py``:
``MultiBranchFusion`` :31-49, ``RefineSFMStage`` :52-108,
``RefineMaskHead`` :117-176, ``SimpleSFMStage`` :179-217,
``SimpleRefineMaskHead`` :220-289, ``refine_cross_entropy_loss`` :292-339,
``RefineRoIHead`` / ``SimpleRefineRoIHead`` :342-420).

RefineMask is DynaMask's ancestor: a semantic FCN branch over P2 (four 3×3
convs and, in ``RefineMaskHead``, a one-channel ``semantic_logits`` map)
beside a 14→28→56→112 instance cascade. Each stage fuses the RoI
features, a crop of the transformed semantic features, the stage's class
logits and a crop of the semantic mask through a ``MultiBranchFusion`` of
three dilated 3×3 convs, then upsamples ×2. Every crop runs through kernel
K2 (``ops.roi_align``; K4 in the backward): per stage one of the semantic
features (C = 256/128/64 at 14²/28²/56², sampling ratio 2) and one of the
one-channel semantic mask, so 6 crops a forward beside the box and mask
extracts. Every per-class 1×1 logit conv is a ``ClassSelectConv1x1``: only
each RoI's class is computed (at LVIS's 1203 classes the full maps of one
image's 300 RoIs at 56² would take 4.5 GB).

Module and parameter names are the reference's mmdet ones
(``instance_convs.i.conv``, ``semantic_convs.i.conv``, ``semantic_logits``,
``stages.i.{semantic_transform_in, semantic_transform_out,
instance_logits, fuse_conv.0, fuse_conv.1.dilation_conv_k.conv,
fuse_conv.1.merge_conv.conv, fuse_transform_out}``,
``final_instance_logits``; ``SimpleRefineMaskHead``'s per-stage logits are
the list ``stage_instance_logits.i``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import (fuse_pair, generate_block_target,
                             interpolate_bilinear)
from ..core.mask_targets import mask_targets_from_crops
from ..ops.roi_align import roi_align, simple_roi_align
from ..utils.registry import HEADS
from .dynamask_head import ClassSelectConv1x1
from .layers import ConvModule, resize_bilinear_2x, to_nchw, to_nhwc
from .losses import binary_cross_entropy_with_logits
from .roi_head import StandardRoIHead


class MultiBranchFusion(nn.Module):
    """Dilated 3×3 branches (ReLU each) summed, then a 1×1 ``merge_conv``;
    ``with_avg`` (``MultiBranchFusionAvg``) adds the input's spatial mean
    to the sum."""

    def __init__(self, feat_dim: int, dilations: Sequence[int] = (1, 3, 5),
                 with_avg: bool = False):
        super().__init__()
        self.num_branches = len(dilations)
        self.with_avg = with_avg
        for i, d in enumerate(dilations):
            self.add_module(f'dilation_conv_{i + 1}', ConvModule(
                feat_dim, feat_dim, 3, padding=d, dilation=d))
        self.merge_conv = ConvModule(feat_dim, feat_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = sum(F.relu(getattr(self, f'dilation_conv_{i + 1}')(x))
                  for i in range(self.num_branches))
        if self.with_avg:
            acc = acc + x.mean(dim=(2, 3), keepdim=True)
        return self.merge_conv(acc)


def _crop(feat: torch.Tensor, rois, roi_batch, out_size: int, scale: float,
          sampling_ratio: int) -> torch.Tensor:
    """(N, C, P, P) RoIAlign of an NCHW map (K2; K4 in the backward)."""
    return to_nchw(roi_align(to_nhwc(feat), rois, roi_batch, out_size, scale,
                             sampling_ratio=sampling_ratio))


def _resize(x: torch.Tensor, s: int) -> torch.Tensor:
    """Bilinear resize of (N, 1, h, w) to s×s, corners aligned."""
    return interpolate_bilinear(x, s, s, align_corners=True)


class RefineSFMStage(nn.Module):
    """One fusion stage of ``RefineMaskHead``: returns the stage's
    class-selected logits (N, 1, s, s) and the fused features at 2s."""

    def __init__(self, semantic_in_channel: int, semantic_out_channel: int,
                 instance_in_channel: int, instance_out_channel: int,
                 out_size: int, num_classes: int,
                 semantic_out_stride: int = 4,
                 fusion_type: str = 'MultiBranchFusion',
                 dilations: Sequence[int] = (1, 3, 5),
                 mask_use_sigmoid: bool = False):
        super().__init__()
        self.out_size = out_size
        self.scale = 1.0 / semantic_out_stride
        self.mask_use_sigmoid = mask_use_sigmoid
        c = instance_in_channel
        self.semantic_transform_in = nn.Conv2d(semantic_in_channel,
                                               semantic_out_channel, 1)
        self.semantic_transform_out = nn.Conv2d(semantic_out_channel,
                                                semantic_out_channel, 1)
        self.instance_logits = ClassSelectConv1x1(c, num_classes)
        self.fuse_conv = nn.ModuleList([
            nn.Conv2d(c + semantic_out_channel + 2, c, 1),
            MultiBranchFusion(c, dilations,
                              with_avg=fusion_type == 'MultiBranchFusionAvg')])
        self.fuse_transform_out = nn.Conv2d(c, instance_out_channel - 2, 1)

    def forward(self, instance_feats, semantic_feat, semantic_pred, rois,
                roi_batch, roi_labels):
        sem = F.relu(self.semantic_transform_in(semantic_feat))
        ins_sem = _crop(sem, rois, roi_batch, self.out_size, self.scale, 2)
        ins_sem = F.relu(self.semantic_transform_out(ins_sem))
        inst = self.instance_logits(instance_feats, roi_labels)
        ip = torch.sigmoid(inst) if self.mask_use_sigmoid else inst
        sp = (torch.sigmoid(semantic_pred) if self.mask_use_sigmoid
              else semantic_pred)
        s = instance_feats.shape[-1]
        # the logits are already s×s: JAX's resize to s×s is the identity
        ins_sem_mask = _crop(sp, rois, roi_batch, s, self.scale, 2)
        fused = torch.cat([instance_feats, ins_sem, ip, ins_sem_mask], 1)
        fused = F.relu(self.fuse_conv[0](fused))
        fused = F.relu(self.fuse_conv[1](fused))
        fused = F.relu(self.fuse_transform_out(fused))
        fused = F.relu(resize_bilinear_2x(fused, align_corners=False))
        s2 = fused.shape[-1]
        fused = torch.cat([fused, _resize(ip, s2), _resize(ins_sem_mask, s2)],
                          1)
        return inst, fused.contiguous(memory_format=torch.channels_last)


class _Towers(nn.Module):
    """The instance and semantic 3×3 conv towers both heads open with."""

    def _towers(self, num_convs_instance, num_convs_semantic,
                instance_in, semantic_in, c_inst, c_sem):
        self.instance_convs = nn.ModuleList([
            ConvModule(instance_in if i == 0 else c_inst, c_inst, 3,
                       padding=1) for i in range(num_convs_instance)])
        self.semantic_convs = nn.ModuleList([
            ConvModule(semantic_in if i == 0 else c_sem, c_sem, 3, padding=1)
            for i in range(num_convs_semantic)])

    def _run_towers(self, instance_feats, semantic_input):
        x = instance_feats
        for conv in self.instance_convs:
            x = F.relu(conv(x))
        sem = semantic_input
        for conv in self.semantic_convs:
            sem = F.relu(conv(sem))
        return x, sem


@HEADS.register_module()
class RefineMaskHead(_Towers):
    """The RefineMask cascade with its semantic logits. ``forward`` returns
    the per-stage class-selected logits [(N, 1, s, s)] for the
    ``stage_sup_size`` and the semantic logits (B, 1, H/4, W/4) of P2."""

    def __init__(self, num_convs_instance: int = 2,
                 num_convs_semantic: int = 4,
                 conv_in_channels_instance: int = 256,
                 conv_in_channels_semantic: int = 256,
                 conv_out_channels_instance: int = 256,
                 conv_out_channels_semantic: int = 256,
                 semantic_out_stride: int = 4,
                 fusion_type: str = 'MultiBranchFusion',
                 dilations: Sequence[int] = (1, 3, 5),
                 mask_use_sigmoid: bool = False,
                 stage_num_classes: Sequence[int] = (80, 80, 80, 80),
                 stage_sup_size: Sequence[int] = (14, 28, 56, 112)):
        super().__init__()
        self.stage_num_classes = tuple(stage_num_classes)
        self._towers(num_convs_instance, num_convs_semantic,
                     conv_in_channels_instance, conv_in_channels_semantic,
                     conv_out_channels_instance, conv_out_channels_semantic)
        self.semantic_logits = nn.Conv2d(conv_out_channels_semantic, 1, 1)
        self.stages = nn.ModuleList()
        out_channel = conv_out_channels_instance
        for idx in range(len(stage_sup_size) - 1):
            in_channel = out_channel
            out_channel = in_channel // 2
            self.stages.append(RefineSFMStage(
                conv_out_channels_semantic, in_channel, in_channel,
                out_channel, stage_sup_size[idx], stage_num_classes[idx],
                semantic_out_stride, fusion_type, dilations,
                mask_use_sigmoid))
        self.final_instance_logits = ClassSelectConv1x1(
            out_channel, stage_num_classes[-1])

    def forward(self, instance_feats, semantic_input, rois, roi_batch,
                roi_labels) -> Tuple[List[torch.Tensor], torch.Tensor]:
        x, sem = self._run_towers(instance_feats, semantic_input)
        semantic_pred = self.semantic_logits(sem)
        preds = []
        for stage in self.stages:
            inst, x = stage(x, sem, semantic_pred, rois, roi_batch,
                            roi_labels)
            preds.append(inst)
        final_labels = (torch.zeros_like(roi_labels)
                        if self.stage_num_classes[-1] == 1 else roi_labels)
        preds.append(self.final_instance_logits(x, final_labels))
        return preds, semantic_pred


class SimpleSFMStage(nn.Module):
    """The lighter fusion stage: no semantic-mask crop; the sigmoid of the
    stage's logits is fused and re-concatenated before the ×2 upsample."""

    def __init__(self, semantic_in_channel: int, semantic_out_channel: int,
                 instance_in_channel: int, instance_out_channel: int,
                 out_size: int, semantic_out_stride: int = 4,
                 fusion_type: str = 'MultiBranchFusionAvg',
                 dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.out_size = out_size
        self.scale = 1.0 / semantic_out_stride
        c = instance_in_channel
        self.semantic_transform_in = nn.Conv2d(semantic_in_channel,
                                               semantic_out_channel, 1)
        self.fuse_conv = nn.ModuleList([
            nn.Conv2d(c + semantic_out_channel + 1, c, 1),
            MultiBranchFusion(c, dilations,
                              with_avg=fusion_type == 'MultiBranchFusionAvg')])
        self.fuse_transform_out = nn.Conv2d(c, instance_out_channel - 1, 1)

    def forward(self, instance_feats, instance_logits, semantic_feat, rois,
                roi_batch, upsample: bool = True):
        sem = F.relu(self.semantic_transform_in(semantic_feat))
        ins_sem = to_nchw(simple_roi_align(to_nhwc(sem), rois, roi_batch,
                                           self.out_size, self.scale))
        sig = torch.sigmoid(instance_logits)
        fused = torch.cat([instance_feats, ins_sem, sig], 1)
        fused = F.relu(self.fuse_conv[0](fused))
        fused = F.relu(self.fuse_conv[1](fused))
        fused = F.relu(self.fuse_transform_out(fused))
        fused = torch.cat([fused, sig], 1)
        if upsample:
            fused = resize_bilinear_2x(fused, align_corners=False)
        return fused.contiguous(memory_format=torch.channels_last)


@HEADS.register_module()
class SimpleRefineMaskHead(_Towers):
    """The lighter RefineMask head: no semantic logits (``forward`` returns
    None for them); each stage's logits come from a 1×1 conv on the
    features entering it, and the last stage's are upsampled ×2 (corners
    aligned) unless ``pre_upsample_last_stage``."""

    def __init__(self, num_convs_instance: int = 2,
                 num_convs_semantic: int = 4,
                 conv_in_channels_instance: int = 256,
                 conv_in_channels_semantic: int = 256,
                 conv_out_channels_instance: int = 256,
                 conv_out_channels_semantic: int = 256,
                 semantic_out_stride: int = 4,
                 fusion_type: str = 'MultiBranchFusionAvg',
                 dilations: Sequence[int] = (1, 3, 5),
                 stage_num_classes: Sequence[int] = (80, 80, 80, 80),
                 stage_sup_size: Sequence[int] = (14, 28, 56, 112),
                 pre_upsample_last_stage: bool = False):
        super().__init__()
        self.stage_num_classes = tuple(stage_num_classes)
        self.pre_upsample_last_stage = pre_upsample_last_stage
        self._towers(num_convs_instance, num_convs_semantic,
                     conv_in_channels_instance, conv_in_channels_semantic,
                     conv_out_channels_instance, conv_out_channels_semantic)
        n_stages = len(stage_sup_size) - 1
        self.stages = nn.ModuleList()
        logits = []
        out_channel = conv_out_channels_instance
        for idx in range(n_stages):
            in_channel = out_channel
            out_channel = in_channel // 2
            logits.append(ClassSelectConv1x1(in_channel,
                                             stage_num_classes[idx]))
            self.stages.append(SimpleSFMStage(
                conv_out_channels_semantic, in_channel, in_channel,
                out_channel, stage_sup_size[idx], semantic_out_stride,
                fusion_type, dilations))
        logits.append(ClassSelectConv1x1(out_channel, stage_num_classes[-1]))
        self.stage_instance_logits = nn.ModuleList(logits)

    def forward(self, instance_feats, semantic_input, rois, roi_batch,
                roi_labels) -> Tuple[List[torch.Tensor], None]:
        x, sem = self._run_towers(instance_feats, semantic_input)
        n_stages = len(self.stages)
        preds = []
        for idx, stage in enumerate(self.stages):
            inst = self.stage_instance_logits[idx](x, roi_labels)
            upsample = self.pre_upsample_last_stage or idx < n_stages - 1
            x = stage(x, inst, sem, rois, roi_batch, upsample)
            preds.append(inst)
        final_labels = (torch.zeros_like(roi_labels)
                        if self.stage_num_classes[-1] == 1 else roi_labels)
        final = self.stage_instance_logits[n_stages](x, final_labels)
        if not self.pre_upsample_last_stage:
            final = resize_bilinear_2x(final, align_corners=True)
        preds.append(final)
        return preds, None


def refine_cross_entropy_loss(stage_instance_preds: Sequence[torch.Tensor],
                              stage_instance_targets: Sequence[torch.Tensor],
                              pos_valid: torch.Tensor,
                              stage_instance_loss_weight: Sequence[float],
                              boundary_width: int = 2,
                              start_stage: int = 1) -> torch.Tensor:
    """The BAR loss's instance part with padded RoI slots masked by
    ``pos_valid``. Stage logits (R, 1, s, s), targets (R, s, s). Up to
    ``start_stage`` the mean BCE over the valid RoIs; after it the BCE over
    the boundary region (the blocks' boundary of the previous stage's
    prediction or target, upsampled), and the next stage's reference
    prediction fuses this stage's logits inside the previous one's boundary
    band with the previous logits upsampled outside it."""
    v = pos_valid.float()
    nv = v.sum().clamp(min=1.0)
    losses = []
    pre_pred = None
    for idx, pred in enumerate(stage_instance_preds):
        logit = pred[:, 0]
        target = stage_instance_targets[idx]
        bce = binary_cross_entropy_with_logits(logit, target)
        if idx <= start_stage:
            losses.append((bce.mean((1, 2)) * v).sum() / nv)
            pre_pred = torch.sigmoid(logit) >= 0.5
            continue
        s = logit.shape[-1]
        pre_b = generate_block_target(pre_pred.float(), boundary_width) == 1
        tgt_b = generate_block_target(stage_instance_targets[idx - 1],
                                      boundary_width) == 1
        region = _resize((pre_b | tgt_b).float(), s) >= 0.5
        region = region & (v[:, None, None] > 0)
        losses.append((bce * region).sum() / region.sum().clamp(min=1.0))
        pre_b1 = _resize((generate_block_target(pre_pred.float(), 1) == 1)
                         .float(), s) >= 0.5
        prev_up = _resize(stage_instance_preds[idx - 1][:, 0], s)
        pre_pred = torch.sigmoid(torch.where(pre_b1, logit, prev_up)) >= 0.5
    if len(stage_instance_loss_weight) != len(losses):
        raise ValueError(f'{len(stage_instance_loss_weight)} stage loss '
                         f'weights for {len(losses)} stages')
    return sum(w * l for w, l in zip(stage_instance_loss_weight, losses))


@HEADS.register_module()
class RefineRoIHead(StandardRoIHead):
    """RefineMask's RoI head: the mask head reads the 14×14 mask extract
    and P2 (``feats[0]``); training adds the BAR loss on targets at each
    ``stage_sup_size`` and, where the batch holds ``gt_semantic`` and the
    head predicts semantic logits, the semantic BCE; the test fuses the
    stages from 28² on at their boundaries up to 112²."""

    def __init__(self, bbox_head, mask_head: nn.Module,
                 stage_sup_size: Tuple[int, ...] = (14, 28, 56, 112),
                 stage_instance_loss_weight: Tuple[float, ...] =
                 (0.25, 0.5, 0.75, 1.0), semantic_loss_weight: float = 1.0,
                 boundary_width: int = 2, start_stage: int = 1, **common):
        super().__init__(bbox_head, mask_head, **common)
        self.stage_sup_size = tuple(stage_sup_size)
        self.stage_instance_loss_weight = tuple(stage_instance_loss_weight)
        self.semantic_loss_weight = semantic_loss_weight
        self.boundary_width = boundary_width
        self.start_stage = start_stage

    @property
    def with_semantic(self) -> bool:
        """Whether a training batch must carry ``gt_semantic``."""
        return isinstance(self.mask_head, RefineMaskHead)

    def _mask_forward(self, feats, rois, roi_batch, roi_labels):
        ins = to_nchw(self._extract(feats, rois, roi_batch,
                                    self.mask_roi_out))
        return self.mask_head(ins, feats[0], rois, roi_batch, roi_labels)

    def _mask_forward_train(self, feats, sample, batch, gumbel_u=None,
                            generator=None):
        boxes, valid, labels, gt, roi_batch = self._pos_rois(sample)
        preds, semantic_pred = self._mask_forward(feats, boxes, roi_batch,
                                                  labels)
        targets = [mask_targets_from_crops(
            batch['gt_crops'], batch['gt_windows'], boxes, roi_batch, gt,
            batch['img_shape'], s) for s in self.stage_sup_size]
        losses = {'loss_instance': refine_cross_entropy_loss(
            preds, targets, valid, self.stage_instance_loss_weight,
            self.boundary_width, self.start_stage)}
        if 'gt_semantic' in batch and semantic_pred is not None:
            sp = semantic_pred[:, 0]
            target = batch['gt_semantic'].float()[:, :sp.shape[1],
                                                  :sp.shape[2]]
            losses['loss_semantic'] = self.semantic_loss_weight * \
                binary_cross_entropy_with_logits(sp, target).mean()
        return losses

    def simple_test_mask(self, feats, dets, labels, batch, rescale=True,
                         routing: Optional[dict] = None):
        """(B, D, 112, 112) mask probabilities: stage 1's logits fused
        with each finer stage's outside the coarser one's boundary band."""
        b, d = dets.shape[:2]
        rois, roi_batch = self._rois(dets, batch, rescale)
        preds, _ = self._mask_forward(feats, rois, roi_batch,
                                      labels.reshape(b * d))
        fused = preds[1][:, 0]
        for p in preds[2:]:
            fused = fuse_pair(fused, p[:, 0])
        probs = torch.sigmoid(fused)
        return probs.reshape(b, d, *probs.shape[1:])


@HEADS.register_module()
class SimpleRefineRoIHead(RefineRoIHead):
    """``RefineRoIHead`` over a ``SimpleRefineMaskHead``: no semantic
    logits, so no semantic loss."""
