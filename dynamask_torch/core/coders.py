"""The delta box coder (port of ``DeltaXYWHBBoxCoder`` in
``dynamask_tpu/core/coders.py``)."""

from __future__ import annotations

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
