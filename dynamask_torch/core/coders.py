"""The box coders (port of ``DeltaXYWHBBoxCoder``,
``LegacyDeltaXYWHBBoxCoder`` and ``TBLRBBoxCoder`` in
``dynamask_tpu/core/coders.py``)."""

from __future__ import annotations

import math

import torch

from .bbox_transforms import WH_RATIO_CLIP, bbox2delta, delta2bbox


class DeltaXYWHBBoxCoder:
    def __init__(self, target_means=(0., 0., 0., 0.),
                 target_stds=(1., 1., 1., 1.)):
        self.means = tuple(target_means)
        self.stds = tuple(target_stds)

    def encode(self, bboxes, gt_bboxes):
        return bbox2delta(bboxes, gt_bboxes, self.means, self.stds)

    def decode(self, bboxes, deltas, max_shape=None,
               wh_ratio_clip=WH_RATIO_CLIP):
        return delta2bbox(bboxes, deltas, self.means, self.stds, max_shape,
                          wh_ratio_clip)


class LegacyDeltaXYWHBBoxCoder(DeltaXYWHBBoxCoder):
    """mmdet v1.x's coder (the ``legacy_1.x`` configs): widths and heights
    of ``x2 - x1 + 1``, decoded corners ``± (w / 2 - 0.5)``; port of the
    JAX ``LegacyDeltaXYWHBBoxCoder`` (``dynamask_tpu/core/coders.py``)."""

    def encode(self, proposals, gt):
        px = (proposals[..., 0] + proposals[..., 2]) * 0.5
        py = (proposals[..., 1] + proposals[..., 3]) * 0.5
        pw = proposals[..., 2] - proposals[..., 0] + 1.0
        ph = proposals[..., 3] - proposals[..., 1] + 1.0
        gx = (gt[..., 0] + gt[..., 2]) * 0.5
        gy = (gt[..., 1] + gt[..., 3]) * 0.5
        gw = gt[..., 2] - gt[..., 0] + 1.0
        gh = gt[..., 3] - gt[..., 1] + 1.0
        deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                              torch.log(gw / pw), torch.log(gh / ph)], -1)
        return (deltas - deltas.new_tensor(self.means)) / \
            deltas.new_tensor(self.stds)

    def decode(self, rois, deltas, max_shape=None,
               wh_ratio_clip=WH_RATIO_CLIP):
        d = deltas.reshape(deltas.shape[:-1] + (-1, 4)) * \
            deltas.new_tensor(self.stds) + deltas.new_tensor(self.means)
        dx, dy, dw, dh = d.unbind(-1)
        max_ratio = abs(math.log(wh_ratio_clip))
        dw = dw.clamp(-max_ratio, max_ratio)
        dh = dh.clamp(-max_ratio, max_ratio)
        px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
        py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
        pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
        ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
        gw = pw * torch.exp(dw)
        gh = ph * torch.exp(dh)
        gx = px + pw * dx
        gy = py + ph * dy
        x1 = gx - gw * 0.5 + 0.5
        y1 = gy - gh * 0.5 + 0.5
        x2 = gx + gw * 0.5 - 0.5
        y2 = gy + gh * 0.5 - 0.5
        if max_shape is not None:
            h, w = max_shape[0] - 1, max_shape[1] - 1
            x1, x2 = x1.clamp(0, w), x2.clamp(0, w)
            y1, y2 = y1.clamp(0, h), y2.clamp(0, h)
        return torch.stack([x1, y1, x2, y2], -1).reshape(deltas.shape)


class TBLRBBoxCoder:
    """FSAF's coder (JAX ``coders.py:85-121``): the (top, bottom, left,
    right) distances of a box's sides from its prior's centre, over the
    prior's height or width (floored at 1e-6) and ``normalizer``; the
    decode clamps to ``max_shape`` (h, w) where it is given."""

    def __init__(self, normalizer: float = 4.0):
        self.normalizer = normalizer

    @staticmethod
    def _prior(priors):
        px = (priors[..., 0] + priors[..., 2]) * 0.5
        py = (priors[..., 1] + priors[..., 3]) * 0.5
        return px, py, priors[..., 2] - priors[..., 0], \
            priors[..., 3] - priors[..., 1]

    def encode(self, priors, gts):
        px, py, w, h = self._prior(priors)
        h, w = h.clamp(min=1e-6), w.clamp(min=1e-6)
        return torch.stack([(py - gts[..., 1]) / h, (gts[..., 3] - py) / h,
                            (px - gts[..., 0]) / w, (gts[..., 2] - px) / w],
                           -1) / self.normalizer

    def decode(self, priors, tblr, max_shape=None):
        t = tblr * self.normalizer
        px, py, w, h = self._prior(priors)
        x1, x2 = px - t[..., 2] * w, px + t[..., 3] * w
        y1, y2 = py - t[..., 0] * h, py + t[..., 1] * h
        if max_shape is not None:
            x1, x2 = x1.clamp(0, max_shape[1]), x2.clamp(0, max_shape[1])
            y1, y2 = y1.clamp(0, max_shape[0]), y2.clamp(0, max_shape[0])
        return torch.stack([x1, y1, x2, y2], -1)
