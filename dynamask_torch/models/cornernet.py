"""CornerNet (port of ``dynamask_tpu/models/cornernet.py``: ``BiCornerPool``
:41, ``_Branch`` :70, ``CornerHead`` :88-131, ``gaussian_radius`` :133,
``corner_targets`` :155-211, ``ae_loss_single`` :213, the ``CornerNet``
detector's losses :260-305 and decode :307-387).

Per HourglassNet stack, a ``BiCornerPool`` for the top-left corners (top
and left pools) and one for the bottom-right (bottom and right), each
feeding a heatmap, an embedding and an offset branch. Training paints
each GT's corners as Gaussians, the max over the GTs of a class
(``corner_targets``, dense), and sums over the stacks: the heatmap focal
loss, the embeddings' pull and push and the corner offsets' SmoothL1. The
heatmap loss is JAX's: ``gaussian_focal_loss`` reduced to its mean over
every cell, then divided by the peak count (mmdet sums over the cells;
ROADMAP.md queue 3, 3bu). Decoding takes the ``corner_topk`` local maxima
of each heatmap (3x3, -inf padding) in JAX's tie order, scores every
top-left x bottom-right pair (-1 where the classes differ, the box is
empty or the embeddings are over ``distance_threshold`` apart), keeps the
``num_dets`` best and runs a class-offset Gaussian Soft-NMS. Plain
PyTorch throughout: the corner pools, the targets and the decode are XLA
in JAX.

Module names follow mmdet's ``CornerHead`` (``tl_pool.{i}``,
``tl_heat.{i}.{0,1}.conv``, ...).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.corner_pool import corner_pool
from ..ops.nms import soft_nms
from ..ops.point_sample import top_k
from ..utils.registry import DETECTORS
from .hourglass import ConvBN
from .layers import ConvModule
from .losses import gaussian_focal_loss, smooth_l1_elementwise
from .single_stage import DenseDetector

HEAT_BIAS = -2.19


class BiCornerPool(nn.Module):
    def __init__(self, in_channels: int, directions: Sequence[str],
                 feat_channels: int = 128, out_channels: int = 256):
        super().__init__()
        self.directions = tuple(directions)
        self.direction1_conv = ConvBN(in_channels, feat_channels, 3)
        self.direction2_conv = ConvBN(in_channels, feat_channels, 3)
        self.aftpool_conv = ConvBN(feat_channels, out_channels, 3, act=False)
        self.conv1 = ConvBN(in_channels, out_channels, 1, act=False)
        self.conv2 = ConvBN(out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = (corner_pool(self.direction1_conv(x), self.directions[0]) +
             corner_pool(self.direction2_conv(x), self.directions[1]))
        return self.conv2(F.relu(self.aftpool_conv(p) + self.conv1(x)))


class Branch(nn.Sequential):
    """mmdet's ``_make_layers``: a biased 3x3 conv with ReLU, a 1x1 conv to
    ``out_channels`` (N(0, 0.01), its bias ``bias``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 feat_channels: int = 256, bias: float = 0.0):
        super().__init__(ConvModule(in_channels, feat_channels, 3, padding=1),
                         ConvModule(feat_channels, out_channels, 1))
        self[1].conv.init_rule = 0.01
        self[1].conv.init_fill = {'bias': bias}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](F.relu(self[0](x)))


class CornerHead(nn.Module):
    BRANCHES = ('tl_heat', 'br_heat', 'tl_emb', 'br_emb', 'tl_off', 'br_off')

    def __init__(self, num_classes: int = 80, in_channels: int = 256,
                 num_feat_levels: int = 2, corner_emb_channels: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.num_feat_levels = num_feat_levels
        levels = range(num_feat_levels)
        self.tl_pool = nn.ModuleList(
            BiCornerPool(in_channels, ('top', 'left'),
                         out_channels=in_channels) for _ in levels)
        self.br_pool = nn.ModuleList(
            BiCornerPool(in_channels, ('bottom', 'right'),
                         out_channels=in_channels) for _ in levels)
        for name, out, bias in (('heat', num_classes, HEAT_BIAS),
                                ('emb', corner_emb_channels, 0.0),
                                ('off', 2, 0.0)):
            for corner in ('tl', 'br'):
                setattr(self, f'{corner}_{name}', nn.ModuleList(
                    Branch(in_channels, out, bias=bias) for _ in levels))

    def forward(self, feats: Sequence[torch.Tensor]):
        """Per level (tl_heat, br_heat, tl_emb, br_emb, tl_off, br_off),
        NCHW."""
        outs = []
        for i in range(self.num_feat_levels):
            pools = {'tl': self.tl_pool[i](feats[i]),
                     'br': self.br_pool[i](feats[i])}
            outs.append(tuple(getattr(self, b)[i](pools[b[:2]])
                              for b in self.BRANCHES))
        return outs


def gaussian_radius(det_h: torch.Tensor, det_w: torch.Tensor,
                    min_overlap: float = 0.3) -> torch.Tensor:
    """The least of the three quadratic bounds (mmdet's
    ``gaussian_radius``)."""
    h, w = det_h, det_w
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 - torch.sqrt(torch.clamp(b1 * b1 - 4 * c1, min=0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp(b2 * b2 - 16 * c2, min=0))) / 8
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - 4 * a3 * c3, min=0))) / \
        (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def corner_targets(gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, feat_h: int, feat_w: int,
                   img_h: float, img_w: float, num_classes: int) -> Dict:
    """Dense corner targets of a batch (B, G) of GTs on a (feat_h, feat_w)
    map of an (img_h, img_w) canvas: heatmaps (B, C, H, W), offsets
    (B, H, W, 2), offset masks (B, H, W) and each GT's corner cells
    (B, G, 2) as (y, x)."""
    wr, hr = feat_w / img_w, feat_h / img_h
    b, g = gt_labels.shape
    dev = gt_boxes.device
    sl, st = gt_boxes[..., 0] * wr, gt_boxes[..., 1] * hr
    sr, sb = gt_boxes[..., 2] * wr, gt_boxes[..., 3] * hr
    li = torch.clamp(sl, max=feat_w - 1).long()
    ti = torch.clamp(st, max=feat_h - 1).long()
    ri = torch.clamp(sr, max=feat_w - 1).long()
    bi = torch.clamp(sb, max=feat_h - 1).long()
    radius = torch.floor(torch.clamp(gaussian_radius(
        torch.ceil(sb - st), torch.ceil(sr - sl)), min=0))
    sigma = (2 * radius + 1) / 6.0
    yy = torch.arange(feat_h, dtype=gt_boxes.dtype, device=dev)
    xx = torch.arange(feat_w, dtype=gt_boxes.dtype, device=dev)
    valid = gt_valid.bool()
    labels = gt_labels.long().clamp(0, num_classes - 1)

    def heat(cy, cx):
        dy = yy[None, None, :, None] - cy[..., None, None].to(yy.dtype)
        dx = xx[None, None, None, :] - cx[..., None, None].to(xx.dtype)
        s = sigma[..., None, None]
        r = radius[..., None, None]
        gsn = torch.exp(-(dx * dx + dy * dy) / (2 * s * s))
        inside = (dy.abs() <= r) & (dx.abs() <= r) & valid[..., None, None]
        gsn = torch.where(inside, gsn, 0.0).reshape(b, g, -1)  # (B, G, HW)
        out = gsn.new_zeros(b, num_classes, feat_h * feat_w)
        out.scatter_reduce_(1, labels[..., None].expand(-1, -1, gsn.shape[2]),
                            gsn, 'amax')
        return out.reshape(b, num_classes, feat_h, feat_w)

    img = torch.arange(b, device=dev)[:, None].expand(b, g)

    def scatter(yi, xi, vals):
        buf = vals.new_zeros(b, feat_h + 1, feat_w, vals.shape[-1])
        yi = torch.where(valid, yi, feat_h)
        buf[img, yi, xi] = vals
        return buf[:, :feat_h]

    one = torch.ones(b, g, 1, dtype=gt_boxes.dtype, device=dev)
    return dict(
        tl_heat=heat(ti, li), br_heat=heat(bi, ri),
        tl_off=scatter(ti, li, torch.stack([sl - li, st - ti], -1)),
        br_off=scatter(bi, ri, torch.stack([sr - ri, sb - bi], -1)),
        tl_mask=scatter(ti, li, one)[..., 0],
        br_mask=scatter(bi, ri, one)[..., 0],
        tl_yx=torch.stack([ti, li], -1), br_yx=torch.stack([bi, ri], -1))


def ae_loss(tl_emb: torch.Tensor, br_emb: torch.Tensor, tl_yx: torch.Tensor,
            br_yx: torch.Tensor, gt_valid: torch.Tensor,
            pull_weight: float = 0.25, push_weight: float = 0.25):
    """The associative embedding's pull and push (JAX ``ae_loss_single``)
    summed over the images: (B, H, W) embeddings, (B, G, 2) corner cells."""
    b = tl_emb.shape[0]
    img = torch.arange(b, device=tl_emb.device)[:, None]
    v = gt_valid.to(tl_emb.dtype)
    n = v.sum(1).clamp(min=1.0)                                     # (B,)
    tl_e = tl_emb[img, tl_yx[..., 0], tl_yx[..., 1]]                # (B, G)
    br_e = br_emb[img, br_yx[..., 0], br_yx[..., 1]]
    me = (tl_e + br_e) / 2.0
    pull = (((tl_e - me) ** 2 + (br_e - me) ** 2) * v).sum(1) / n
    conf = 1.0 - (me[:, :, None] - me[:, None, :]).abs()
    g = v.shape[1]
    pair_v = v[:, :, None] * v[:, None, :] * (
        1.0 - torch.eye(g, dtype=v.dtype, device=v.device))
    push = (conf.clamp(min=0) * pair_v).sum((1, 2))
    push = (n > 1).to(v.dtype) * push / (n * (n - 1)).clamp(min=1.0)
    return pull_weight * pull.sum(), push_weight * push.sum()


@DETECTORS.register_module()
class CornerNet(DenseDetector):
    """HourglassNet and ``CornerHead`` without a neck: ``forward_train``
    gives ``det_loss``, ``pull_loss``, ``push_loss`` and ``off_loss`` (no
    random draw); ``simple_test`` dets (B, max_per_img, 5), labels and
    det_valid."""

    def __init__(self, backbone: nn.Module, bbox_head: CornerHead,
                 num_classes: int = 80, pull_weight: float = 0.25,
                 push_weight: float = 0.25, offset_beta: float = 1.0,
                 corner_topk: int = 100, local_maximum_kernel: int = 3,
                 distance_threshold: float = 0.5, num_dets: int = 1000,
                 score_thr: float = 0.05, nms_iou_thr: float = 0.5,
                 nms_sigma: float = 0.5, max_per_img: int = 100):
        super().__init__(backbone, nn.Identity(), bbox_head, num_classes, 0,
                         score_thr, nms_iou_thr, max_per_img)
        self.pull_weight, self.push_weight = pull_weight, push_weight
        self.offset_beta = offset_beta
        self.corner_topk = corner_topk
        self.local_maximum_kernel = local_maximum_kernel
        self.distance_threshold = distance_threshold
        self.num_dets = num_dets
        self.nms_sigma = nms_sigma

    def forward_train(self, batch: Dict[str, torch.Tensor],
                      noise: Optional[dict] = None,
                      generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        _, outs = self.head(batch)
        with record_function('loss'):
            _, img_h, img_w = batch['image'].shape[:3]
            fh, fw = outs[-1][0].shape[-2:]
            tgt = corner_targets(batch['gt_boxes'].float(),
                                 batch['gt_labels'], batch['gt_valid'], fh,
                                 fw, float(img_h), float(img_w),
                                 self.num_classes)
            det_l = pull_l = push_l = off_l = 0.0
            for tl_heat, br_heat, tl_emb, br_emb, tl_off, br_off in outs:
                det = 0.0
                for heat, t in ((tl_heat, tgt['tl_heat']),
                                (br_heat, tgt['br_heat'])):
                    avg = (t == 1.0).sum().to(t.dtype).clamp(min=1.0)
                    det = det + gaussian_focal_loss(
                        torch.sigmoid(heat.float()), t).sum() / avg
                det_l = det_l + det / 2.0
                pl, ps = ae_loss(tl_emb[:, 0].float(), br_emb[:, 0].float(),
                                 tgt['tl_yx'], tgt['br_yx'],
                                 batch['gt_valid'], self.pull_weight,
                                 self.push_weight)
                pull_l, push_l = pull_l + pl, push_l + ps
                off = 0.0
                for pred, t, mask in ((tl_off, tgt['tl_off'], tgt['tl_mask']),
                                      (br_off, tgt['br_off'],
                                       tgt['br_mask'])):
                    el = smooth_l1_elementwise(
                        pred.float().permute(0, 2, 3, 1), t, self.offset_beta)
                    off = off + (el * mask[..., None]).sum() / (
                        mask.sum() * 2).clamp(min=1.0)
                off_l = off_l + off / 2.0
        return {'det_loss': det_l, 'pull_loss': pull_l, 'push_loss': push_l,
                'off_loss': off_l}

    def _topk_corners(self, heat: torch.Tensor):
        """(C, H, W) sigmoid scores -> the ``corner_topk`` local maxima:
        scores, y, x, class, taken in (y, x, class) order."""
        c, h, w = heat.shape
        kk = self.local_maximum_kernel
        hmax = F.max_pool2d(heat[None], kk, 1, (kk - 1) // 2)[0]
        scores = (heat * (hmax == heat)).permute(1, 2, 0).reshape(-1)
        top_s, top_i = top_k(scores, self.corner_topk)
        yx = top_i // c
        return top_s, yx // w, yx % w, top_i % c

    @torch.no_grad()
    def simple_test(self, batch: Dict[str, torch.Tensor],
                    rescale: bool = True) -> Dict[str, torch.Tensor]:
        _, outs = self.head(batch)
        with record_function('get_dets'):
            tl_heat, br_heat, tl_emb, br_emb, tl_off, br_off = outs[-1]
            b = tl_heat.shape[0]
            fh, fw = tl_heat.shape[-2:]
            inp_h, inp_w = batch['image'].shape[1:3]
            border = batch.get('border')
            results = [self._decode(
                tl_heat[i].float(), br_heat[i].float(), tl_emb[i, 0].float(),
                br_emb[i, 0].float(), tl_off[i].float(), br_off[i].float(),
                None if border is None else border[i],
                batch['scale_factor'][i], inp_w / fw, inp_h / fh, rescale)
                for i in range(b)]
        return {k: torch.stack([r[j] for r in results])
                for j, k in enumerate(('dets', 'labels', 'det_valid'))}

    def _decode(self, tl_h, br_h, tl_e, br_e, tl_o, br_o, border, scale,
                rx: float, ry: float, rescale: bool):
        k = self.corner_topk
        tl_s, tl_y, tl_x, tl_c = self._topk_corners(torch.sigmoid(tl_h))
        br_s, br_y, br_x, br_c = self._topk_corners(torch.sigmoid(br_h))
        by0, bx0 = (0.0, 0.0) if border is None else (border[0], border[2])
        tx = ((tl_x + tl_o[0, tl_y, tl_x]) * rx - bx0).clamp(min=0.0)
        ty = ((tl_y + tl_o[1, tl_y, tl_x]) * ry - by0).clamp(min=0.0)
        bx = ((br_x + br_o[0, br_y, br_x]) * rx - bx0).clamp(min=0.0)
        by = ((br_y + br_o[1, br_y, br_x]) * ry - by0).clamp(min=0.0)
        boxes = torch.stack(torch.broadcast_tensors(
            tx[:, None], ty[:, None], bx[None, :], by[None, :]),
            -1).reshape(-1, 4)
        scores = (tl_s[:, None] + br_s[None, :]) / 2.0
        dist = (tl_e[tl_y, tl_x][:, None] - br_e[br_y, br_x][None, :]).abs()
        bad = ((tl_c[:, None] != br_c[None, :]) |
               (bx[None, :] <= tx[:, None]) | (by[None, :] <= ty[:, None]) |
               (dist > self.distance_threshold))
        scores = torch.where(bad, -1.0, scores).reshape(-1)
        labels = tl_c[:, None].expand(k, k).reshape(-1)
        top_s, top_i = top_k(scores, self.num_dets)
        boxes, labels = boxes[top_i], labels[top_i]
        if rescale:
            boxes = boxes / scale.to(boxes.dtype)
        valid = top_s > -0.1
        max_coord = torch.where(valid[:, None], boxes, 0.0).max() + 1.0
        shifted = boxes + (labels.to(boxes.dtype) * max_coord)[:, None]
        _, ns, keep, nv = soft_nms(shifted, top_s, valid,
                                   iou_threshold=self.test_cfg['iou_thr'],
                                   sigma=self.nms_sigma, method='gaussian',
                                   max_out=self.test_cfg['max_per_img'])
        out_boxes = torch.where(nv[:, None], boxes[keep], 0.0)
        out_labels = torch.where(nv, labels[keep], 0)
        nv = nv & (ns > self.test_cfg['score_thr'])
        return torch.cat([out_boxes, ns[:, None]], -1), out_labels, nv
