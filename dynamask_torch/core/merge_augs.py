"""Test-time augmentation merging (port of
``dynamask_tpu/core/merge_augs.py``): boxes map back through each
augmentation's (scale, flip), scores average across the augmentations,
mask probabilities average after the flip back."""

from __future__ import annotations

from typing import Sequence

import torch

from .bbox_transforms import bbox_mapping, bbox_mapping_back


def recover_boxes(boxes: torch.Tensor, img_shape, scale_factor,
                  flip: bool) -> torch.Tensor:
    """An augmentation's boxes -> original-image coordinates: flipped in
    the augmentation's frame, then divided by the 4-vector
    ``scale_factor``."""
    return bbox_mapping_back(boxes, img_shape, scale_factor, flip)


def to_aug_frame(boxes: torch.Tensor, img_shape, scale_factor,
                 flip: bool) -> torch.Tensor:
    """Original-image boxes -> an augmentation's frame: scaled, then
    flipped."""
    return bbox_mapping(boxes, img_shape, scale_factor, flip)


def merge_aug_bboxes(aug_boxes: Sequence[torch.Tensor],
                     aug_scores: Sequence[torch.Tensor]):
    """The mean of the recovered boxes and of the scores."""
    return (sum(aug_boxes) / len(aug_boxes),
            sum(aug_scores) / len(aug_scores))


def merge_aug_masks(aug_masks: Sequence[torch.Tensor],
                    flips: Sequence[bool]) -> torch.Tensor:
    """The mean of (..., H, W) mask probabilities, each flipped back on its
    last axis where its augmentation was flipped."""
    out = 0.0
    for m, flip in zip(aug_masks, flips):
        out = out + (m.flip(-1) if flip else m)
    return out / len(aug_masks)


def merge_aug_scores(aug_scores: Sequence[torch.Tensor]) -> torch.Tensor:
    return sum(aug_scores) / len(aug_scores)
