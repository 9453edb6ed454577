"""Grid R-CNN's RoI head (port of ``dynamask_tpu/models/grid_rcnn.py``:
``_neighbor_points`` :33, ``calc_sub_regions`` :50, ``GridHead`` :102,
``grid_targets`` :173, ``grid_refine_boxes`` :218, ``GridRoIHead`` :260).

The box branch classifies only (``with_reg=False`` in every grid config:
zero deltas keep the proposals' geometry); a 3x3 grid of points on the
2x-expanded RoI is found from heatmaps, and the points' maxima vote the
box edges (Grid R-CNN Plus: each point's heatmap covers half the map).
The grid head reads a 14x14 crop (K2; K4 in the backward) of the
positives sampled a second time and jittered, FPN-routed or, under GRoIE's
box extractor, from every level (the grid extract takes the box
extractor's mode, as in JAX; ROADMAP.md queue 3, 3z); at inference, of
the dets. Its work is the profiler range ``grid_branch``.

``GridHead``'s names are mmdet's: ``convs.i.{conv, gn}`` (biased convs),
``forder_trans.i.j.{0, 1}`` and ``sorder_trans.i.j.{0, 1}`` (a 5x5
depthwise and a 1x1 conv from point ``neighbors[i][j]`` to point i),
``deconv1`` / ``deconv2`` (``ConvTranspose2d`` in 9 groups, one a point),
``norm1``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..utils.registry import HEADS
from .layers import GroupNorm, to_nchw
from .losses import binary_cross_entropy_with_logits
from .roi_head import StandardRoIHead


def neighbor_points(grid_size: int) -> List[Tuple[int, ...]]:
    """Each grid point's neighbours: left, up, down, right of the
    column-major grid, where they exist."""
    pts = []
    for i in range(grid_size):
        for j in range(grid_size):
            nb = []
            if i > 0:
                nb.append((i - 1) * grid_size + j)
            if j > 0:
                nb.append(i * grid_size + j - 1)
            if j < grid_size - 1:
                nb.append(i * grid_size + j + 1)
            if i < grid_size - 1:
                nb.append((i + 1) * grid_size + j)
            pts.append(tuple(nb))
    return pts


def calc_sub_regions(grid_points: int, whole_map_size: int):
    """Each point's half-sized sub-region (x1, y1, x2, y2) of the whole
    heatmap."""
    grid_size = int(np.sqrt(grid_points))
    half_size = whole_map_size // 4 * 2
    subs = []
    for i in range(grid_points):
        x_idx, y_idx = i // grid_size, i % grid_size
        firsts = []
        for idx in (x_idx, y_idx):
            if idx == 0:
                firsts.append(0)
            elif idx == grid_size - 1:
                firsts.append(half_size)
            else:
                firsts.append(max(int((idx / (grid_size - 1) - 0.25) *
                                      whole_map_size), 0))
        sub_x1, sub_y1 = firsts
        subs.append((sub_x1, sub_y1, sub_x1 + half_size, sub_y1 + half_size))
    return subs


class ConvGN(nn.Module):
    """mmcv's ``ConvModule(norm_cfg=GN, bias=True)``: a biased conv under
    ``.conv`` and a GroupNorm under ``.gn``."""

    def __init__(self, in_channels: int, out_channels: int, stride: int,
                 groups: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, 1)
        self.gn = GroupNorm(groups, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gn(self.conv(x))


def _trans(c: int) -> nn.Sequential:
    """A 5x5 depthwise then a 1x1 conv over one point's channels."""
    return nn.Sequential(nn.Conv2d(c, c, 5, padding=2, groups=c),
                         nn.Conv2d(c, c, 1))


@HEADS.register_module()
class GridHead(nn.Module):
    """The conv tower, the first- and second-order fusion of each point's
    features with its neighbours', and the grouped deconvs to one heatmap
    a point: (N, C, roi, roi) -> {'fused', 'unfused'} (N, points,
    4 * roi // 2, ...); ``unfused`` (the tower's own features through the
    deconvs) only with ``train``."""

    def __init__(self, grid_points: int = 9, num_convs: int = 8,
                 roi_feat_size: int = 14, in_channels: int = 256,
                 point_feat_channels: int = 64, gn_groups: int = 36):
        super().__init__()
        self.grid_points = grid_points
        self.roi_feat_size = roi_feat_size
        self.point_feat_channels = c = point_feat_channels
        cout = c * grid_points
        self.neighbors = neighbor_points(int(np.sqrt(grid_points)))
        self.convs = nn.ModuleList(
            ConvGN(in_channels if i == 0 else cout, cout, 2 if i == 0 else 1,
                   gn_groups) for i in range(num_convs))
        self.forder_trans = nn.ModuleList(
            nn.ModuleList(_trans(c) for _ in nbs) for nbs in self.neighbors)
        self.sorder_trans = nn.ModuleList(
            nn.ModuleList(_trans(c) for _ in nbs) for nbs in self.neighbors)
        self.deconv1 = nn.ConvTranspose2d(cout, cout, 4, 2, 1,
                                          groups=grid_points)
        self.norm1 = GroupNorm(grid_points, cout)
        self.deconv2 = nn.ConvTranspose2d(cout, grid_points, 4, 2, 1,
                                          groups=grid_points)
        self.deconv1.init_rule = self.deconv2.init_rule = 0.001
        # the rare-positive prior of the reference
        self.deconv2.init_fill = {'bias': -math.log(0.99 / 0.01)}

    def _heatmaps(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv2(F.relu(self.norm1(self.deconv1(x))))

    def forward(self, x: torch.Tensor, train: bool = False
                ) -> Dict[str, torch.Tensor]:
        for conv in self.convs:
            x = F.relu(conv(x))
        c = self.point_feat_channels
        points = [x[:, i * c:(i + 1) * c] for i in range(self.grid_points)]
        x_fo = []
        for i, nbs in enumerate(self.neighbors):
            acc = points[i]
            for j, p in enumerate(nbs):
                acc = acc + self.forder_trans[i][j](points[p])
            x_fo.append(acc)
        x_so = []
        for i, nbs in enumerate(self.neighbors):
            acc = points[i]
            for j, p in enumerate(nbs):
                acc = acc + self.sorder_trans[i][j](x_fo[p])
            x_so.append(acc)
        fused = self._heatmaps(torch.cat(x_so, 1))
        return {'fused': fused,
                'unfused': self._heatmaps(x) if train else fused}


def _sub_regions(grid_points: int, whole_map_size: int,
                 device) -> torch.Tensor:
    return torch.tensor(calc_sub_regions(grid_points, whole_map_size),
                        dtype=torch.float32, device=device)


def grid_targets(pos_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 grid_points: int, whole_map_size: int,
                 pos_radius: int = 1) -> torch.Tensor:
    """(R, points, half, half) heatmap targets: the pixels within
    ``pos_radius`` of each GT grid point's cell in its point's sub-region
    of the 2x-expanded RoI; zero for an expanded RoI of at most
    ``grid_size`` pixels a side."""
    grid_size = int(np.sqrt(grid_points))
    half = whole_map_size // 4 * 2
    dev = pos_boxes.device
    subs = _sub_regions(grid_points, whole_map_size, dev)
    w = pos_boxes[:, 2] - pos_boxes[:, 0]
    h = pos_boxes[:, 3] - pos_boxes[:, 1]
    ex1 = pos_boxes[:, 0] - w / 2
    ey1 = pos_boxes[:, 1] - h / 2
    ew, eh = 2 * w, 2 * h
    factors = torch.tensor(
        [(1 - (j // grid_size) / (grid_size - 1),
          1 - (j % grid_size) / (grid_size - 1)) for j in range(grid_points)],
        dtype=torch.float32, device=dev)
    fx, fy = factors[:, 0][None], factors[:, 1][None]
    gx = fx * gt_boxes[:, 0:1] + (1 - fx) * gt_boxes[:, 2:3]     # (R, P)
    gy = fy * gt_boxes[:, 1:2] + (1 - fy) * gt_boxes[:, 3:4]
    cx = torch.floor((gx - ex1[:, None]) / ew[:, None].clamp(min=1e-6) *
                     whole_map_size)
    cy = torch.floor((gy - ey1[:, None]) / eh[:, None].clamp(min=1e-6) *
                     whole_map_size)
    r = torch.arange(half, dtype=torch.float32, device=dev)
    dx = r[None, None] + subs[None, :, 0, None] - cx[..., None]  # (R, P, w)
    dy = r[None, None] + subs[None, :, 1, None] - cy[..., None]  # (R, P, h)
    d2 = dx[:, :, None, :] ** 2 + dy[:, :, :, None] ** 2
    target = (d2 <= pos_radius ** 2).float()
    valid = ((ew > grid_size) & (eh > grid_size)).float()
    return target * valid[:, None, None, None]


def grid_refine_boxes(dets: torch.Tensor, heatmaps: torch.Tensor,
                      grid_points: int, whole_map_size: int,
                      img_shape: torch.Tensor) -> torch.Tensor:
    """One image's boxes (R, 4) voted from its dets (R, 5) and their
    heatmaps (R, points, half, half): each edge the score-weighted mean of
    its three points' maxima, mapped back from the expanded RoI and
    clipped to ``img_shape`` (h, w)."""
    grid_size = int(np.sqrt(grid_points))
    half = whole_map_size // 4 * 2
    subs = _sub_regions(grid_points, whole_map_size, dets.device)
    r = dets.shape[0]
    flat = torch.sigmoid(heatmaps.float()).reshape(r, grid_points,
                                                   half * half)
    scores, pos = flat.max(-1)
    xs = (pos % half).float() + subs[None, :, 0]
    ys = (pos // half).float() + subs[None, :, 1]
    boxes = dets[:, :4]
    w = (boxes[:, 2] - boxes[:, 0])[:, None]
    h = (boxes[:, 3] - boxes[:, 1])[:, None]
    x1 = boxes[:, 0:1] - w / 2
    y1 = boxes[:, 1:2] - h / 2
    abs_x = (xs + 0.5) / half * w + x1
    abs_y = (ys + 0.5) / half * h + y1

    def vote(vals, idx):
        s = scores[:, idx]
        return (vals[:, idx] * s).sum(-1) / s.sum(-1).clamp(min=1e-6)

    x1_idx = list(range(grid_size))
    y1_idx = [i * grid_size for i in range(grid_size)]
    x2_idx = [grid_points - grid_size + i for i in range(grid_size)]
    y2_idx = [(i + 1) * grid_size - 1 for i in range(grid_size)]
    voted = torch.stack([vote(abs_x, x1_idx), vote(abs_y, y1_idx),
                         vote(abs_x, x2_idx), vote(abs_y, y2_idx)], -1)
    return torch.minimum(voted.clamp(min=0), img_shape.flip(-1).repeat(2))


# the grid loss's weight and the jitter's amplitude, fixed in JAX
# (``grid_rcnn.py:267, :338``) and in every grid file
GRID_LOSS_WEIGHT = 15.0
JITTER = 0.15


@HEADS.register_module()
class GridRoIHead(StandardRoIHead):
    """The box branch, which classifies only (its head has no ``fc_reg``:
    zero deltas, and the box loss at weight 0 as JAX's ``with_reg=False``
    trains it), and the grid branch (``grid_head``) on ``grid_roi_out``
    crops. Training samples the positives a second time (``noise``
    'rcnn_grid', the candidates' priorities) and jitters them (``noise``
    'grid_jitter' (B * max_pos, 4), uniform in ±``JITTER``), drawing from
    the generator what is not given."""

    aug_test_refusal = ('its box head has no regression, and JAX\'s '
                        'aug_test decodes its deltas (None)')

    def __init__(self, bbox_head, grid_head: GridHead, grid_roi_out: int = 14,
                 pos_radius: int = 1, **common):
        super().__init__(bbox_head, None, **dict(common, loss_bbox_weight=0.0))
        self.grid_head = grid_head
        self.grid_roi_out = grid_roi_out
        self.pos_radius = pos_radius

    def _bbox_forward(self, feats, rois, roi_batch):
        cls_logits, _ = super()._bbox_forward(feats, rois, roi_batch)
        return cls_logits, cls_logits.new_zeros(cls_logits.shape[0],
                                                4 * self.num_classes)

    def _grid_maps(self, feats, rois, roi_batch, train: bool):
        return self.grid_head(to_nchw(self._extract(
            feats, rois, roi_batch, self.grid_roi_out)), train)

    def forward_train(self, feats, proposals, proposal_valid, batch,
                      noise=None, generator=None):
        noise = noise or {}
        losses = super().forward_train(feats, proposals, proposal_valid,
                                       batch, noise, generator)
        with record_function('grid_branch'):
            losses['loss_grid'] = self._grid_loss(feats, proposals,
                                                  proposal_valid, batch,
                                                  noise, generator)
        return losses

    def _grid_loss(self, feats, proposals, proposal_valid, batch, noise,
                   generator):
        """The grid branch's loss on the positives of a second sampling,
        jittered."""
        sample = self._sample_rois(proposals, proposal_valid, batch,
                                   noise.get('rcnn_grid'), generator)
        boxes, valid, _, gt, roi_batch = self._pos_rois(sample)
        jit = noise.get('grid_jitter')
        if jit is None:
            jit = (torch.rand(boxes.shape, generator=generator,
                              device=boxes.device) * 2 - 1) * JITTER
        jit = jit.to(boxes.device, torch.float32)
        cxcy = (boxes[:, 2:] + boxes[:, :2]) / 2
        wh = (boxes[:, 2:] - boxes[:, :2]).abs()
        new_cxcy = cxcy + wh * jit[:, :2]
        new_wh = wh * (1 + jit[:, 2:])
        wh_max = batch['img_shape'].float()[roi_batch].flip(-1) - 1
        jb = torch.minimum(torch.cat([new_cxcy - new_wh / 2,
                                      new_cxcy + new_wh / 2], -1).clamp(min=0),
                           wh_max.repeat(1, 2))
        pred = self._grid_maps(feats, jb, roi_batch, train=True)
        b, g = batch['gt_boxes'].shape[:2]
        gt_idx = (roi_batch.long() * g + gt.long()).clamp(0, b * g - 1)
        tgt = grid_targets(jb, batch['gt_boxes'].reshape(b * g, 4).float()[
            gt_idx], self.grid_head.grid_points,
            self.grid_head.roi_feat_size * 4, self.pos_radius)
        w = valid.float()[:, None, None, None]
        avg = (w.sum() * tgt[0].numel()).clamp(min=1.0)
        loss = sum((binary_cross_entropy_with_logits(pred[k].float(), tgt) *
                    w).sum() / avg for k in ('fused', 'unfused'))
        return GRID_LOSS_WEIGHT * loss

    def simple_test(self, feats, proposals, proposal_valid, batch,
                    rescale: bool = True):
        """The box branch's dets at the input's scale, each box replaced
        by the grid's vote (then brought to the original scale with
        ``rescale``)."""
        result = super().simple_test(feats, proposals, proposal_valid,
                                     batch, rescale=False)
        dets = result['dets']
        b, d = dets.shape[:2]
        with record_function('grid_branch'):
            roi_batch = torch.arange(b, device=dets.device
                                     ).repeat_interleave(d)
            maps = self._grid_maps(feats, dets[..., :4].reshape(b * d, 4),
                                   roi_batch, train=False)['fused']
            maps = maps.reshape(b, d, *maps.shape[1:])
            new = []
            for i in range(b):
                refined = grid_refine_boxes(
                    dets[i], maps[i], self.grid_head.grid_points,
                    self.grid_head.roi_feat_size * 4, batch['img_shape'][i])
                if rescale:
                    refined = refined / batch['scale_factor'][i, :4].to(
                        refined.dtype)
                new.append(torch.cat([refined, dets[i, :, 4:5]], -1))
        return {'dets': torch.stack(new), 'labels': result['labels'],
                'det_valid': result['det_valid']}
