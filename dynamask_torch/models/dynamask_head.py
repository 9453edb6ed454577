"""DynaMask mask cascade and Mask Switch Module (port of
``dynamask_tpu/models/dynamask_head.py``: ``DCNPack``, ``SFMStage``,
``ClassSelectConv1x1``, ``DynaMaskHead``, ``MaskPre``, :37-364, and
``gumbel_softmax`` :367-384).

Training runs the same modules: ``DCNPack`` through the DCN's autograd
function (K1 and K3), which keeps only its inputs for the backward, as the
JAX package rematerialises the DCN under training
(``dynamask_head.py:79-80``); ``MaskPre``'s two BatchNorms use batch
statistics in training mode.

Two instance convs at 14×14, then three ``SFMStage``s 14→28→56 halving the
channels, then class-agnostic final logits upsampled ×2 to 112. Each stage
fuses the RoI features with a 1/4-scale crop of an FPN level through a 1×1
conv and the bounded-window DCN (kernel K1 via ``ops.deform_conv``). The
crops run through kernel K2 (``ops.roi_align``).

Reference quirk kept (``faithful_stride_quirk``, :278-282): every stage
crops at scale 1/``semantic_out_stride[-1]`` = 1/4 from
``semantic_feats[-idx-3]`` (P4, P3, P2), which are strides 16/8/4.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deform_conv import deform_conv2d_nhwc
from ..ops.roi_align import simple_roi_align
from ..utils.registry import HEADS
from .layers import (BatchNorm2dBiasedVar, ConvModule, resize_bilinear_2x,
                     to_nchw, to_nhwc)


class DCNPack(nn.Module):
    """3×3 DCNv1 with self-predicted offsets (mmcv ``DeformConv2dPack``): a
    ``conv_offset`` conv and a bias-free ``weight``."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, deform_groups: int = 2,
                 window: int = 3):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.deform_groups, self.window = k, deform_groups, \
            window
        self.conv_offset = nn.Conv2d(in_channels, 2 * deform_groups * k * k,
                                     k, padding=(k - 1) // 2)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               k, k))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        out = deform_conv2d_nhwc(to_nhwc(x), to_nhwc(self.conv_offset(x)),
                                 self.weight, k, (k - 1) // 2, 1,
                                 self.deform_groups, self.window)
        return to_nchw(out)


class ClassSelectConv1x1(nn.Module):
    """Per-class 1×1 logit conv evaluated only at each RoI's class.

    Holds the weights of ``nn.Conv2d(C, num_classes, 1)`` (mmdet names and
    layout) and applies the selected class's row as one dot per pixel —
    the reference's ``conv(x)[arange(N), labels]`` without the all-class
    map. The dot and the bias are summed in fp32 and the logit is cast back
    to the input's type, as the JAX module does
    (``dynamask_tpu/models/dynamask_head.py:148-152``)."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.weight = nn.Parameter(torch.empty(num_classes, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.empty(num_classes))

    def forward(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W), (N,) -> (N, 1, H, W)."""
        safe = labels.long().clamp(0, self.num_classes - 1)
        w_sel = self.weight[safe, :, 0, 0].to(x.dtype)       # (N, C)
        out = torch.einsum('nchw,nc->nhw', x.float(), w_sel.float())
        out = out + self.bias[safe].float()[:, None, None]
        return out.to(x.dtype)[:, None]


class SFMStage(nn.Module):
    """Semantic fusion stage (reference dynamask_head.py:54-125)."""

    def __init__(self, semantic_in_channel: int, semantic_out_channel: int,
                 instance_in_channel: int, instance_out_channel: int,
                 out_size: int, num_classes: int, semantic_scale: float,
                 upsample: bool = True, dcn_window: int = 3):
        super().__init__()
        self.out_size = out_size
        self.semantic_scale = semantic_scale
        self.upsample = upsample
        c = instance_in_channel
        self.semantic_transform_in = nn.Conv2d(semantic_in_channel,
                                               semantic_out_channel, 1)
        self.instance_logits = ClassSelectConv1x1(c, num_classes)
        self.detail_logits = ClassSelectConv1x1(c, num_classes)
        self.fuse_conv = nn.ModuleList([
            nn.Conv2d(c + semantic_out_channel + 2, c, 1),
            DCNPack(c, c, deform_groups=2, window=dcn_window)])
        self.fuse_transform_out = nn.Conv2d(c, instance_out_channel - 2, 1)

    def forward(self, instance_feats, semantic_feat, rois, roi_batch,
                roi_labels):
        sem = F.relu(self.semantic_transform_in(semantic_feat))
        ins_sem = to_nchw(simple_roi_align(to_nhwc(sem), rois, roi_batch,
                                           self.out_size, self.semantic_scale))
        inst = self.instance_logits(instance_feats, roi_labels)
        det = self.detail_logits(instance_feats, roi_labels)
        inst_sig, det_sig = torch.sigmoid(inst), torch.sigmoid(det)
        fused = torch.cat([instance_feats, ins_sem, inst_sig, det_sig], 1)
        fused = F.relu(self.fuse_conv[0](fused))
        fused = F.relu(self.fuse_conv[1](fused))
        fused = F.relu(self.fuse_transform_out(fused))
        fused = torch.cat([fused, inst_sig, det_sig], 1)
        if self.upsample:
            fused = F.relu(resize_bilinear_2x(fused, align_corners=False))
        return inst, det, fused.contiguous(memory_format=torch.channels_last)


class DetailTarget(nn.Module):
    """Holds the trainable detail-target fuse kernel of the reference loss
    (cross_entropy_loss.py:371, shape (1, 2, 1, 1)), the JAX tree's
    ``detail_fuse_weights``. Training reads it in ``dyna_mask_loss``; its
    thresholded targets give it zero gradient, so only weight decay moves
    it."""

    def __init__(self):
        super().__init__()
        self.fuse_kernel = nn.Parameter(torch.empty(1, 2, 1, 1))


class _LossFunc(nn.Module):
    def __init__(self):
        super().__init__()
        self.detail_target = DetailTarget()


@HEADS.register_module()
class DynaMaskHead(nn.Module):
    """The 14→28→56→112 cascade (reference dynamask_head.py:128-244)."""

    def __init__(self, num_convs_instance: int = 2,
                 conv_out_channels_instance: int = 256,
                 conv_out_channels_semantic: int = 256,
                 semantic_out_stride: Sequence[int] = (16, 8, 4),
                 stage_num_classes: Sequence[int] = (80, 80, 80, 1),
                 stage_sup_size: Sequence[int] = (14, 28, 56, 112),
                 pre_upsample_last_stage: bool = False,
                 faithful_stride_quirk: bool = True, dcn_window: int = 3):
        super().__init__()
        self.stage_num_classes = tuple(stage_num_classes)
        self.pre_upsample_last_stage = pre_upsample_last_stage
        c = conv_out_channels_instance
        self.instance_convs = nn.ModuleList(
            [ConvModule(c, c, 3, padding=1) for _ in range(num_convs_instance)])
        num_stages = len(stage_sup_size) - 1
        self.stages = nn.ModuleList()
        out_channel = c
        for idx in range(num_stages):
            in_channel = out_channel
            out_channel = in_channel // 2
            stride = (semantic_out_stride[-1] if faithful_stride_quirk
                      else semantic_out_stride[idx])
            self.stages.append(SFMStage(
                conv_out_channels_semantic, in_channel, in_channel,
                out_channel, stage_sup_size[idx], stage_num_classes[idx],
                1.0 / stride,
                upsample=pre_upsample_last_stage or idx < num_stages - 1,
                dcn_window=dcn_window))
        self.final_instance_logits = ClassSelectConv1x1(out_channel,
                                                        stage_num_classes[-1])
        self.final_detail_logits = ClassSelectConv1x1(out_channel,
                                                      stage_num_classes[-1])
        self.loss_func = _LossFunc()

    def forward(self, instance_feats: torch.Tensor,
                semantic_feats: Sequence[torch.Tensor], rois: torch.Tensor,
                roi_batch: torch.Tensor, roi_labels: torch.Tensor,
                stage_max_rois: Optional[Tuple[int, ...]] = None):
        """``instance_feats`` (R, C, 14, 14); ``semantic_feats`` the FPN
        levels P2..P6 (NCHW); ``rois`` (R, 4) image coordinates.

        ``stage_max_rois``: static per-stage RoI capacities of the bucketed
        dynamic path; the caller passes RoIs sorted by routing need and each
        stage runs on a prefix. Returns per-stage (R_s, 1, s, s) instance and
        detail logits."""
        x = instance_feats
        for conv in self.instance_convs:
            x = F.relu(conv(x))
        inst_preds: List[torch.Tensor] = []
        det_preds: List[torch.Tensor] = []
        cur_rois, cur_batch, cur_labels = rois, roi_batch, roi_labels
        for idx, stage in enumerate(self.stages):
            if stage_max_rois is not None:
                k = min(stage_max_rois[idx], x.shape[0])
                x, cur_rois = x[:k], cur_rois[:k]
                cur_batch, cur_labels = cur_batch[:k], cur_labels[:k]
            inst, det, x = stage(x, semantic_feats[-idx - 3], cur_rois,
                                 cur_batch, cur_labels)
            inst_preds.append(inst)
            det_preds.append(det)
        if stage_max_rois is not None:
            k = min(stage_max_rois[-1], x.shape[0])
            x, cur_labels = x[:k], cur_labels[:k]
        # class-agnostic final stage when stage_num_classes[-1] == 1
        final_labels = (torch.zeros_like(cur_labels)
                        if self.stage_num_classes[-1] == 1 else cur_labels)
        inst = self.final_instance_logits(x, final_labels)
        det = self.final_detail_logits(x, final_labels)
        if not self.pre_upsample_last_stage:
            inst = resize_bilinear_2x(inst, align_corners=True)
            det = resize_bilinear_2x(det, align_corners=True)
        inst_preds.append(inst)
        det_preds.append(det)
        return inst_preds, det_preds


class MaskPre(nn.Module):
    """The Mask Switch Module CNN (reference base_roi_head.py:10-27):
    56×56 crop -> 1×1 conv to 128 + BN + ReLU + pool -> 3×3 conv to 16 + BN
    + ReLU + pool -> fc 3136→512 -> fc 512→``num_choices``.

    ``mode='project'`` applies conv1 without its bias to a whole plane;
    ``mode='head'`` adds the bias back after the crop. A bias-free 1×1 conv
    commutes with the (linear, zero-outside) RoI crop, so
    ``head(crop(project(x))) == full(crop(x))`` exactly."""

    def __init__(self, num_choices: int = 4, in_channels: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, 128, 1)
        self.bn1 = BatchNorm2dBiasedVar(128, eps=1e-5)
        self.conv2 = nn.Conv2d(128, 16, 3, padding=1)
        self.bn2 = BatchNorm2dBiasedVar(16, eps=1e-5)
        self.fc1 = nn.Linear(16 * 14 * 14, 512)
        self.fc2 = nn.Linear(512, num_choices)

    def forward(self, x: torch.Tensor, mode: str = 'full') -> torch.Tensor:
        if mode == 'project':
            return F.conv2d(x, self.conv1.weight)
        if mode == 'head':
            x = x + self.conv1.bias[None, :, None, None]
        else:
            x = self.conv1(x)
        # F.max_pool2d pads with -inf, as flax's max_pool does
        x = F.max_pool2d(F.relu(self.bn1(x)), 3, 2, 1)
        x = F.max_pool2d(F.relu(self.bn2(self.conv2(x))), 3, 2, 1)
        x = x.reshape(x.shape[0], -1)                # CHW order, 3136
        return self.fc2(F.relu(self.fc1(x)))


def gumbel_softmax(logits: torch.Tensor, temperature: float = 0.5,
                   hard: bool = True, eps: float = 1e-20,
                   u: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Straight-through Gumbel-softmax. ``u`` injects the uniform noise
    (the tests give both sides the same draws); otherwise it is drawn from
    ``generator``."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator,
                       device=logits.device)
    # the noise stays fp32 (jax.random.uniform's type) whatever the logits'
    # type, so bf16 logits plus it are fp32, as in the JAX package
    u = u.to(logits.device, torch.promote_types(logits.dtype, torch.float32))
    g = -torch.log((-torch.log(u.clamp(min=eps))).clamp(min=eps))
    y = F.softmax((logits + g) / temperature, dim=-1)
    if not hard:
        return y
    y_hard = F.one_hot(y.argmax(-1), logits.shape[-1]).to(y.dtype)
    return (y_hard - y).detach() + y
