"""Static-shape batch formatting, the host/device contract (port of
``dynamask_tpu/data/formatting.py``).

The host emits fixed-shape arrays once per image:

  * the image padded into an orientation-bucketed static canvas;
  * GT boxes and labels padded to ``max_gts`` with validity flags;
  * each GT's mask rasterized once into a fixed ``crop_size``² window crop
    (polygons filled in window coordinates, no resampling), from which the
    device encodes every stage resolution (14..112) by RoIAlign
    (``core/mask_targets.py``).

``collate`` stacks same-canvas samples into a batch of torch tensors, which
``train_steps`` and ``single_device_test`` move to the device.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .mask_codec import ann_to_mask


def canvas_for(h: int, w: int,
               canvases: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Pick the smallest canvas that fits (h, w)."""
    fitting = [c for c in canvases if c[0] >= h and c[1] >= w]
    if not fitting:
        raise ValueError(f'no canvas fits image {(h, w)}: {canvases}')
    return min(fitting, key=lambda c: c[0] * c[1])


def rasterize_mask_crop(segm, window: np.ndarray, crop_size: int,
                        ori_hw: Tuple[int, int],
                        scale_factor: np.ndarray,
                        flip: bool) -> np.ndarray:
    """Rasterize one GT mask into its (crop_size, crop_size) window crop.

    Polygons (already resized and flipped) are filled directly at crop
    resolution. RLE (crowd) masks are decoded at original resolution,
    flipped if flagged, cropped to the window mapped back to original
    pixels, resized and thresholded.
    """
    import cv2
    x1, y1, x2, y2 = window
    sx = crop_size / max(x2 - x1, 1e-6)
    sy = crop_size / max(y2 - y1, 1e-6)
    out = np.zeros((crop_size, crop_size), np.uint8)
    if isinstance(segm, dict):
        mask = ann_to_mask({k: v for k, v in segm.items()
                            if not k.startswith('_')},
                           ori_hw[0], ori_hw[1])
        if segm.get('_flip', flip):
            mask = mask[:, ::-1]
        # the window is in resized coordinates: map it back
        ox1 = x1 / scale_factor[0]
        oy1 = y1 / scale_factor[1]
        ox2 = x2 / scale_factor[0]
        oy2 = y2 / scale_factor[1]
        ix1, iy1 = max(int(np.floor(ox1)), 0), max(int(np.floor(oy1)), 0)
        ix2 = min(int(np.ceil(ox2)), mask.shape[1])
        iy2 = min(int(np.ceil(oy2)), mask.shape[0])
        if ix2 > ix1 and iy2 > iy1:
            sub = mask[iy1:iy2, ix1:ix2]
            out = cv2.resize(sub.astype(np.uint8), (crop_size, crop_size),
                             interpolation=cv2.INTER_LINEAR)
            out = (out >= 0.5).astype(np.uint8)
        return out
    pts = [((np.asarray(p, np.float32).reshape(-1, 2) -
             np.array([x1, y1], np.float32)) *
            np.array([sx, sy], np.float32)).round().astype(np.int32)
           for p in segm]
    if pts:
        cv2.fillPoly(out, pts, 1)
    return out


def format_sample(results: Dict, canvases: Sequence[Tuple[int, int]],
                  max_gts: int = 100, crop_size: int = 128,
                  crop_margin: float = 2.0,
                  max_ignore: int = 20) -> Dict[str, np.ndarray]:
    """One pipeline output -> static-shape arrays (before batching)."""
    img = results['img']
    h, w = img.shape[:2]
    ch, cw = canvas_for(h, w, canvases)
    canvas = np.zeros((ch, cw, img.shape[2]), np.float32)
    canvas[:h, :w] = img

    out = {
        'image': canvas,
        'img_shape': np.array(results.get('img_shape', img.shape)[:2],
                              np.float32),
        'ori_shape': np.array(results['ori_shape'][:2], np.float32),
        'scale_factor': np.asarray(results.get(
            'scale_factor', np.ones(4, np.float32)), np.float32),
        'flip': np.array(results.get('flip', False)),
    }

    if 'gt_bboxes' in results:
        boxes = np.asarray(results['gt_bboxes'], np.float32).reshape(-1, 4)
        labels = np.asarray(results.get('gt_labels', []),
                            np.int64).reshape(-1)
        n = min(len(boxes), max_gts)
        gt_boxes = np.zeros((max_gts, 4), np.float32)
        gt_labels = np.zeros(max_gts, np.int32)
        gt_valid = np.zeros(max_gts, bool)
        gt_boxes[:n] = boxes[:n]
        gt_labels[:n] = labels[:n]
        gt_valid[:n] = True
        out.update(gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid)

        ig = np.asarray(results.get('gt_bboxes_ignore', np.zeros((0, 4))),
                        np.float32).reshape(-1, 4)
        m = min(len(ig), max_ignore)
        gt_ignore = np.zeros((max_ignore, 4), np.float32)
        gt_ignore_valid = np.zeros(max_ignore, bool)
        gt_ignore[:m] = ig[:m]
        gt_ignore_valid[:m] = True
        out.update(gt_ignore=gt_ignore, gt_ignore_valid=gt_ignore_valid)

        if 'gt_masks' in results:
            crops = np.zeros((max_gts, crop_size, crop_size), np.uint8)
            windows = np.zeros((max_gts, 4), np.float32)
            sf = out['scale_factor']
            for i in range(n):
                b = boxes[i]
                win = np.array([b[0] - crop_margin, b[1] - crop_margin,
                                b[2] + crop_margin, b[3] + crop_margin],
                               np.float32)
                windows[i] = win
                crops[i] = rasterize_mask_crop(
                    results['gt_masks'][i], win, crop_size,
                    tuple(out['ori_shape'].astype(int)), sf,
                    bool(out['flip']))
            out.update(gt_crops=crops, gt_windows=windows)
    return out


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """Stack same-canvas samples into a batch of (host) torch tensors."""
    return {k: torch.from_numpy(np.stack([s[k] for s in samples], 0))
            for k in samples[0]}
