"""SSD (port of ``dynamask_tpu/models/ssd.py:34-319``): the VGG-16
backbone with ceil-mode pools, the dilated fc6 / fc7 convs, the extra
layers and ``L2Norm`` on conv4_3; a 3x3 class conv and box conv a level;
softmax cross entropy with 3:1 hard-negative mining and SmoothL1 on the
positives; at test time the ``nms_pre`` best anchors a level, softmax
without the background, then ``multiclass_nms``.

The module and parameter names are mmdet's (``backbone.features.{i}`` of
the VGG ``Sequential``, ``backbone.extra.{i}``, ``backbone.l2_norm.weight``,
``bbox_head.cls_convs.{i}`` / ``reg_convs.{i}``). No RoIAlign and no
deformable conv runs here, so no hand kernel: the convs are cuDNN's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..core.anchors import LegacySSDAnchorGenerator, SSDAnchorGenerator
from ..core.assigners import MaxIoUAssigner
from ..core.coders import DeltaXYWHBBoxCoder, LegacyDeltaXYWHBBoxCoder
from ..core.fp16 import at_least_f32
from ..ops.point_sample import top_k
from ..utils.registry import BACKBONES, DETECTORS, HEADS
from .losses import smooth_l1_elementwise
from .single_stage import DenseDetector, dense_nms, flatten_levels

# VGG-16's stages: (channels, convs)
VGG16 = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# the extra layers a canvas: an int is a conv to that many channels,
# alternately 1x1 and 3x3 (no padding); 'S' makes the next one a 3x3 of
# stride 2 and padding 1 (JAX ``SSDVGG.extra_setting``)
EXTRA_SETTING = {
    300: (256, 'S', 512, 128, 'S', 256, 128, 256, 128, 256),
    512: (256, 'S', 512, 128, 'S', 256, 128, 'S', 256, 128, 'S', 256, 128),
}


class L2Norm(nn.Module):
    """Each location's channel vector over its L2 norm (in fp32 at least,
    as ``core/fp16.py`` rules, plus 1e-10), times a learned per-channel
    scale, initially 20."""

    def __init__(self, channels: int, scale: float = 20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.init_fill = {'weight': scale}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = at_least_f32(x).pow(2).sum(1, keepdim=True).sqrt() + 1e-10
        return x / norm.to(x.dtype) * self.weight.to(x.dtype)[None, :, None,
                                                               None]


def _extra_layers(in_channels: int, plan) -> List[Tuple[int, int, int, int]]:
    """(in, out, kernel, stride) of each extra conv of ``plan``."""
    layers, i, cin = [], 0, in_channels
    while i < len(plan):
        if plan[i] == 'S':
            layers.append((cin, plan[i + 1], 3, 2))
            i += 2
        else:
            layers.append((cin, plan[i], 1 if len(layers) % 2 == 0 else 3, 1))
            i += 1
        cin = layers[-1][1]
    return layers


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    """VGG-16 through conv5_3 (2x2 ceil-mode pools after stages 1-4, a 3x3
    stride-1 pool after stage 5), fc6 (3x3 at dilation 6) and fc7 (1x1),
    each conv with its ReLU, as mmcv's ``features`` ``Sequential``
    (indices 0-34); then the extra layers, each with its ReLU. Outputs:
    ``L2Norm(conv4_3)``, fc7, and every second extra layer's output (six
    levels on a 300 canvas: 38, 19, 10, 5, 3, 1)."""

    # the index of conv4_3's ReLU in ``features`` (mmdet's
    # ``out_feature_indices[0]``)
    CONV4_3 = 22

    def __init__(self, input_size: int = 300, l2_norm_scale: float = 20.0):
        super().__init__()
        if input_size not in EXTRA_SETTING:
            raise NotImplementedError(f'SSDVGG input_size {input_size}')
        layers: List[nn.Module] = []
        cin = 3
        for si, (ch, n) in enumerate(VGG16):
            for _ in range(n):
                layers += [nn.Conv2d(cin, ch, 3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = ch
            if si < 4:
                layers.append(nn.MaxPool2d(2, 2, ceil_mode=True))
        layers += [nn.MaxPool2d(3, 1, 1),
                   nn.Conv2d(cin, 1024, 3, padding=6, dilation=6),
                   nn.ReLU(inplace=True), nn.Conv2d(1024, 1024, 1),
                   nn.ReLU(inplace=True)]
        self.features = nn.Sequential(*layers)
        self.extra = nn.ModuleList(
            [nn.Conv2d(i, o, k, stride=s, padding=1 if s == 2 else 0)
             for i, o, k, s in _extra_layers(1024,
                                             EXTRA_SETTING[input_size])])
        self.l2_norm = L2Norm(VGG16[3][0], l2_norm_scale)
        self.out_channels = (VGG16[3][0], 1024) + tuple(
            c.out_channels for c in self.extra[1::2])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i == self.CONV4_3:
                outs.append(self.l2_norm(x))
        outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)


@HEADS.register_module()
class SSDHead(nn.Module):
    """A 3x3 class conv (``num_anchors * (num_classes + 1)`` outputs, the
    background last) and a 3x3 box conv (``num_anchors * 4``) a level."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 num_anchors: Sequence[int]):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = nn.ModuleList(
            [nn.Conv2d(c, a * (num_classes + 1), 3, padding=1)
             for c, a in zip(in_channels, num_anchors)])
        self.reg_convs = nn.ModuleList(
            [nn.Conv2d(c, a * 4, 3, padding=1)
             for c, a in zip(in_channels, num_anchors)])

    def forward(self, feats: Sequence[torch.Tensor]):
        return ([conv(x) for conv, x in zip(self.cls_convs, feats)],
                [conv(x) for conv, x in zip(self.reg_convs, feats)])


def ssd_targets(flat_cls: torch.Tensor, anchors: torch.Tensor,
                anchor_valid: torch.Tensor, batch: Dict[str, torch.Tensor],
                assigner: MaxIoUAssigner, coder, num_classes: int,
                neg_pos_ratio: int):
    """Per image, the anchors assigned to its GTs and the hard negatives
    (JAX ``ssd.py:229-258``): -> (labels (B, A) with ``num_classes`` the
    background, positives, kept negatives, each anchor's GT index (B, A),
    encoded targets (B, A, 4), the cross entropy (B, A) against the
    labels). A negative is kept when its cross-entropy rank among the
    image's negatives (descending, ties in anchor order) is under
    ``neg_pos_ratio`` times the image's positives."""
    out = [[] for _ in range(6)]
    k = batch['gt_boxes'].shape[1]
    for i in range(flat_cls.shape[0]):
        a = assigner(anchors, anchor_valid[i], batch['gt_boxes'][i],
                     batch['gt_valid'][i], batch['gt_labels'][i])
        pos = a.gt_inds > 0
        neg = (a.gt_inds == 0) & anchor_valid[i].bool()
        labels = torch.where(pos, a.labels, num_classes)
        ce = -F.log_softmax(flat_cls[i], -1).gather(-1, labels[:, None])[:, 0]
        order = torch.argsort(-torch.where(neg, ce, float('-inf')),
                              stable=True)
        rank = torch.argsort(order)
        keep_neg = neg & (rank < neg_pos_ratio * pos.sum())
        gt_idx = (a.gt_inds - 1).clamp(0, k - 1)
        tgt = coder.encode(anchors, batch['gt_boxes'][i][gt_idx])
        for lst, v in zip(out, (labels, pos, keep_neg, gt_idx, tgt, ce)):
            lst.append(v)
    return tuple(torch.stack(v) for v in out)


@DETECTORS.register_module()
class SSD(DenseDetector):
    """``SSDVGG`` and ``SSDHead`` without a neck; mmdet v1.x's anchors and
    coder with ``legacy``. ``forward_train``: the mined cross entropy and
    the positives' SmoothL1, both over the batch's positive count;
    ``simple_test``: dets (B, max_per_img, 5), labels, det_valid."""

    def __init__(self, backbone: nn.Module, bbox_head: nn.Module,
                 num_classes: int = 80, input_size: int = 300,
                 strides=(8, 16, 32, 64, 100, 300),
                 ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                 basesize_ratio_range=(0.15, 0.9),
                 target_means=(0., 0., 0., 0.),
                 target_stds=(0.1, 0.1, 0.2, 0.2), pos_iou_thr: float = 0.5,
                 neg_iou_thr: float = 0.5, min_pos_iou: float = 0.2,
                 neg_pos_ratio: int = 3, smoothl1_beta: float = 1.0,
                 nms_pre: int = 1000, score_thr: float = 0.02,
                 nms_iou_thr: float = 0.45, max_per_img: int = 200,
                 legacy: bool = False):
        super().__init__(backbone, nn.Identity(), bbox_head, num_classes,
                         nms_pre, score_thr, nms_iou_thr, max_per_img)
        gen = LegacySSDAnchorGenerator if legacy else SSDAnchorGenerator
        self.anchor_generator = gen(strides, ratios, basesize_ratio_range,
                                    input_size)
        self.bbox_coder = (LegacyDeltaXYWHBBoxCoder if legacy else
                           DeltaXYWHBBoxCoder)(target_means, target_stds)
        self.assigner = MaxIoUAssigner(pos_iou_thr, neg_iou_thr, min_pos_iou,
                                       match_low_quality=True)
        self.neg_pos_ratio = neg_pos_ratio
        self.smoothl1_beta = smoothl1_beta

    def anchors(self, feats):
        sizes = [tuple(f.shape[-2:]) for f in feats]
        return self.anchor_generator.grid_anchors(sizes, feats[0].device), \
            sizes

    def targets(self, batch):
        """The head's flat outputs and :func:`ssd_targets` of ``batch``:
        (flat_cls (B, A, C + 1), flat_reg (B, A, 4), anchors (A, 4),
        targets)."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('loss'):
            mlvl, sizes = self.anchors(feats)
            anchors = torch.cat(mlvl)
            valid = torch.cat(self.anchor_generator.valid_flags(
                sizes, batch['img_shape']), 1)
            flat_cls = flatten_levels(cls_scores, self.num_classes + 1)
            flat_reg = flatten_levels(bbox_preds, 4)
            return flat_cls, flat_reg, anchors, ssd_targets(
                flat_cls, anchors, valid, batch, self.assigner,
                self.bbox_coder, self.num_classes, self.neg_pos_ratio)

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """The losses of a padded batch; nothing is drawn at random."""
        _, flat_reg, _, (_, pos, keep_neg, _, tgt, ce) = self.targets(batch)
        with record_function('loss'):
            total_pos = pos.sum().clamp(min=1).to(ce.dtype)
            cls_l = ((ce * pos).sum(1) + (ce * keep_neg).sum(1)).sum()
            reg_l = (smooth_l1_elementwise(flat_reg, tgt, self.smoothl1_beta)
                     * pos[..., None]).sum()
            return {'loss_cls': cls_l / total_pos,
                    'loss_bbox': reg_l / total_pos}

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        """Per level the softmax scores of the ``nms_pre`` anchors of
        highest foreground score (all of a level with fewer, in anchor
        order), their boxes decoded; then clipped, rescaled and
        ``multiclass_nms`` over the foreground classes."""
        feats, (cls_scores, bbox_preds) = self.head(batch)
        with record_function('get_dets'):
            mlvl, _ = self.anchors(feats)
            nc1 = self.num_classes + 1
            boxes, scores = [], []
            for cs, bp, anc in zip(cls_scores, bbox_preds, mlvl):
                s = torch.softmax(flatten_levels([cs], nc1), -1)
                r = flatten_levels([bp], 4)
                k = min(self.test_cfg['nms_pre'], s.shape[1])
                if k < s.shape[1]:
                    idx = top_k(s[..., :-1].max(-1).values, k)[1]
                    s = s.gather(1, idx[..., None].expand(-1, -1, nc1))
                    r = r.gather(1, idx[..., None].expand(-1, -1, 4))
                    anc = anc[idx]
                else:
                    anc = anc.expand(s.shape[0], -1, -1)
                boxes.append(self.bbox_coder.decode(anc, r))
                scores.append(s[..., :-1])
            cfg = self.test_cfg
            return dense_nms(torch.cat(boxes, 1), torch.cat(scores, 1), batch,
                             cfg['score_thr'], cfg['iou_thr'],
                             cfg['max_per_img'], rescale)
