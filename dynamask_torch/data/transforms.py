"""Host-side image and annotation transforms, numpy + cv2 (port of the part
of ``dynamask_tpu/data/transforms.py`` that the COCO instance and VOC
pipelines use: ``configs/_base_/datasets/coco_instance.py``, and
``LoadProposals`` :63-82 for Fast R-CNN's precomputed proposals, which
``Resize`` and ``RandomFlip`` move with the image; CornerNet's
``PhotoMetricDistortion`` :291-327 and ``RandomCenterCropPad`` :654-762,
and the reference's formatting transforms ``DefaultFormatBundle``,
``Collect`` and ``ImageToTensor`` :772-799, which leave the results as
they are: static formatting collects a fixed set of fields later).

Each transform maps a results dict to a results dict; masks stay polygon
lists (or RLE dicts with pending ``_scale``/``_flip`` flags) until static
formatting, since polygons transform exactly and bitmaps do not. Random
draws come from ``results['_rng']`` (a ``numpy.random.RandomState``, one
unseeded per sample unless the caller puts one there).
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import PIPELINES


@PIPELINES.register_module()
class LoadImageFromFile:
    def __init__(self, to_float32: bool = False, color_type: str = 'color'):
        self.to_float32 = to_float32

    def __call__(self, results: Dict) -> Dict:
        import cv2
        path = osp.join(results.get('img_prefix', ''),
                        results['img_info']['file_name'])
        img = cv2.imread(path, cv2.IMREAD_COLOR)  # BGR
        if img is None:
            raise FileNotFoundError(path)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = path
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results


@PIPELINES.register_module()
class LoadAnnotations:
    def __init__(self, with_bbox: bool = True, with_mask: bool = False,
                 with_label: bool = True, poly2mask: bool = False):
        self.with_bbox = with_bbox
        self.with_mask = with_mask
        self.with_label = with_label

    def __call__(self, results: Dict) -> Dict:
        ann = results['ann_info']
        if self.with_bbox:
            results['gt_bboxes'] = ann['bboxes'].copy()
            results['gt_bboxes_ignore'] = ann['bboxes_ignore'].copy()
        if self.with_label:
            results['gt_labels'] = ann['labels'].copy()
        if self.with_mask:
            results['gt_masks'] = ann['masks']  # polygon lists / RLE dicts
        return results


@PIPELINES.register_module()
class LoadProposals:
    """The proposals the dataset put in ``results['proposals']`` (from its
    ``proposal_file``): (N, 4|5), the score column dropped, the first
    ``num_max_proposals`` kept; none gives one zero box."""

    def __init__(self, num_max_proposals: Optional[int] = None):
        self.num_max_proposals = num_max_proposals

    def __call__(self, results: Dict) -> Dict:
        props = np.asarray(results['proposals'], np.float32)
        if props.ndim != 2 or props.shape[1] not in (4, 5):
            raise ValueError(f'proposals must be (N, 4|5), got '
                             f'{props.shape}')
        props = props[:self.num_max_proposals, :4]
        if len(props) == 0:
            props = np.zeros((1, 4), np.float32)
        results['proposals'] = props
        return results


@PIPELINES.register_module()
class Resize:
    """Keep-ratio resize to fit inside img_scale (max_long, max_short), or
    an exact (w, h) resize without keep_ratio. Several scales sample one per
    sample: 'range' draws the long and short edge uniformly between the
    scales', 'value' picks one of them."""

    def __init__(self, img_scale=(1333, 800), keep_ratio: bool = True,
                 multiscale_mode: str = 'range'):
        if isinstance(img_scale[0], (list, tuple)):
            self.scales = [tuple(s) for s in img_scale]
        else:
            self.scales = [tuple(img_scale)]
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode

    def _pick_scale(self, rng: np.random.RandomState):
        if len(self.scales) == 1:
            return self.scales[0]
        if self.multiscale_mode == 'value':
            return self.scales[rng.randint(len(self.scales))]
        longs = [max(s) for s in self.scales]
        shorts = [min(s) for s in self.scales]
        long_edge = rng.randint(min(longs), max(longs) + 1)
        short_edge = rng.randint(min(shorts), max(shorts) + 1)
        return (long_edge, short_edge)

    def __call__(self, results: Dict) -> Dict:
        import cv2
        rng = results.setdefault('_rng', np.random.RandomState())
        scale = self._pick_scale(rng)
        img = results['img']
        h, w = img.shape[:2]
        if self.keep_ratio:
            max_long, max_short = max(scale), min(scale)
            factor = min(max_long / max(h, w), max_short / min(h, w))
            new_w = int(w * factor + 0.5)
            new_h = int(h * factor + 0.5)
        else:
            # scale is (w, h), mmcv's order for a fixed-size resize
            new_w, new_h = scale
        if (new_w, new_h) != (w, h):
            img = cv2.resize(img, (new_w, new_h),
                             interpolation=cv2.INTER_LINEAR)
        w_scale = new_w / w
        h_scale = new_h / h
        results['img'] = img
        results['img_shape'] = img.shape
        results['scale_factor'] = np.array(
            [w_scale, h_scale, w_scale, h_scale], np.float32)
        if 'gt_bboxes' in results:
            for key in ('gt_bboxes', 'gt_bboxes_ignore'):
                boxes = results[key] * results['scale_factor']
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, img.shape[1])
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, img.shape[0])
                results[key] = boxes
        if 'proposals' in results:     # the proposals follow the image
            props = results['proposals'] * results['scale_factor']
            props[:, 0::2] = np.clip(props[:, 0::2], 0, img.shape[1])
            props[:, 1::2] = np.clip(props[:, 1::2], 0, img.shape[0])
            results['proposals'] = props
        if 'gt_masks' in results:
            results['gt_masks'] = [
                _scale_segm(m, w_scale, h_scale) for m in results['gt_masks']]
        return results


def _scale_segm(segm, w_scale: float, h_scale: float):
    if isinstance(segm, dict):  # RLE: flagged, handled in bitmap space later
        out = dict(segm)
        out['_scale'] = (segm.get('_scale', (1.0, 1.0))[0] * w_scale,
                         segm.get('_scale', (1.0, 1.0))[1] * h_scale)
        return out
    return [np.asarray(p, np.float32).reshape(-1, 2) *
            np.array([w_scale, h_scale], np.float32) for p in segm]


def _flip_segm(segm, img_w: float):
    if isinstance(segm, dict):
        out = dict(segm)
        out['_flip'] = not segm.get('_flip', False)
        return out
    return [np.stack([img_w - p[:, 0], p[:, 1]], 1) for p in segm]


@PIPELINES.register_module()
class RandomFlip:
    def __init__(self, flip_ratio: float = 0.5, direction: str = 'horizontal'):
        self.flip_ratio = flip_ratio or 0.0
        if direction != 'horizontal':
            raise NotImplementedError(f'RandomFlip direction {direction!r}: '
                                      'the port flips horizontally only')

    def __call__(self, results: Dict) -> Dict:
        rng = results.setdefault('_rng', np.random.RandomState())
        flip = rng.rand() < self.flip_ratio
        results['flip'] = flip
        if not flip:
            return results
        results['img'] = np.ascontiguousarray(results['img'][:, ::-1])
        w = results['img'].shape[1]
        if 'gt_bboxes' in results:
            for key in ('gt_bboxes', 'gt_bboxes_ignore'):
                boxes = results[key].copy()
                boxes[:, 0] = w - results[key][:, 2]
                boxes[:, 2] = w - results[key][:, 0]
                results[key] = boxes
        if 'proposals' in results:
            props = results['proposals'].copy()
            props[:, 0] = w - results['proposals'][:, 2]
            props[:, 2] = w - results['proposals'][:, 0]
            results['proposals'] = props
        if 'gt_masks' in results:
            results['gt_masks'] = [_flip_segm(m, w)
                                   for m in results['gt_masks']]
        return results


@PIPELINES.register_module()
class Normalize:
    """BGR->RGB + per-channel standardize (reference Normalize:457)."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results: Dict) -> Dict:
        img = results['img'].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results['img'] = (img - self.mean) / self.std
        results['img_norm_cfg'] = dict(mean=self.mean, std=self.std,
                                       to_rgb=self.to_rgb)
        return results


@PIPELINES.register_module()
class Pad:
    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, pad_val: float = 0):
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = ((h + d - 1) // d) * d, ((w + d - 1) // d) * d
        out = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
        out[:h, :w] = img
        results['img'] = out
        results['pad_shape'] = out.shape
        return results


def _shift_segm(segm, dx: float, dy: float):
    if isinstance(segm, dict):
        out = dict(segm)
        sx, sy = out.get('_shift', (0.0, 0.0))
        out['_shift'] = (sx + dx, sy + dy)
        return out
    return [p + np.array([dx, dy], np.float32) for p in segm]


@PIPELINES.register_module()
class PhotoMetricDistortion:
    """Brightness, contrast, saturation and hue jitter of the BGR image
    before ``Normalize``, each applied on a coin flip of
    ``results['_rng']`` in the JAX package's order of draws."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, results: Dict) -> Dict:
        import cv2
        rng = results.setdefault('_rng', np.random.RandomState())
        img = results['img'].astype(np.float32)
        if rng.randint(2):
            img += rng.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_last = rng.randint(2)
        if not contrast_last and rng.randint(2):
            img *= rng.uniform(*self.contrast_range)
        hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                           cv2.COLOR_BGR2HSV).astype(np.float32)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(*self.saturation_range)
        if rng.randint(2):
            hsv[..., 0] = (hsv[..., 0] + rng.uniform(-self.hue_delta,
                                                     self.hue_delta)) % 180
        img = cv2.cvtColor(np.clip(hsv, 0, 255).astype(np.uint8),
                           cv2.COLOR_HSV2BGR).astype(np.float32)
        if contrast_last and rng.randint(2):
            img *= rng.uniform(*self.contrast_range)
        results['img'] = np.clip(img, 0, 255)
        return results


@PIPELINES.register_module()
class RandomCenterCropPad:
    """CornerNet's crop. Training: a crop of ``crop_size`` times a ratio
    drawn from ``ratios``, centred at a random point at least the (shrunk)
    ``border`` inside the image, pasted onto a mean-filled canvas; the GTs
    whose centres fall in the crop are kept (100 draws at most, then the
    results as they came). Test: the image mean-padded around its centre
    to ``h | 127`` x ``w | 127`` (``test_pad_mode``), or to a multiple."""

    def __init__(self, crop_size=None, ratios=(0.9, 1.0, 1.1), border=128,
                 mean=None, std=None, to_rgb=None, test_mode=False,
                 test_pad_mode=('logical_or', 127)):
        if mean is None or std is None or to_rgb is None:
            raise ValueError('RandomCenterCropPad needs mean, std and '
                             'to_rgb')
        self.crop_size = crop_size
        self.ratios = ratios
        self.border = border
        self.mean = list(mean[::-1]) if to_rgb else list(mean)
        self.test_mode = test_mode
        self.test_pad_mode = test_pad_mode

    @staticmethod
    def _get_border(border, size):
        k = 2 * border / size
        i = pow(2, np.ceil(np.log2(np.ceil(k))) + (k == int(k)))
        return int(border // i)

    def _crop_paste(self, image, center_y, center_x, th, tw):
        h, w, c = image.shape
        x0 = max(0, center_x - tw // 2)
        x1 = min(center_x + tw // 2, w)
        y0 = max(0, center_y - th // 2)
        y1 = min(center_y + th // 2, h)
        patch = np.array((int(x0), int(y0), int(x1), int(y1)))
        left, right = center_x - x0, x1 - center_x
        top, bottom = center_y - y0, y1 - center_y
        cy, cx = th // 2, tw // 2
        canvas = np.empty((th, tw, c), dtype=image.dtype)
        canvas[...] = np.asarray(self.mean, dtype=image.dtype)
        canvas[cy - top:cy + bottom, cx - left:cx + right] = \
            image[y0:y1, x0:x1]
        return canvas, (cx - left - x0, cy - top - y0), patch

    def __call__(self, results: Dict) -> Dict:
        img = results['img']
        h, w = img.shape[:2]
        if self.test_mode:
            mode, value = self.test_pad_mode
            if mode == 'logical_or':
                th, tw = h | value, w | value
            else:
                th = int(np.ceil(h / value) * value)
                tw = int(np.ceil(w / value) * value)
            canvas, (dx, dy), _ = self._crop_paste(img, h // 2, w // 2,
                                                   th, tw)
            results['img'] = canvas
            results['img_shape'] = canvas.shape
            if 'gt_bboxes' in results and len(results['gt_bboxes']):
                results['gt_bboxes'] = results['gt_bboxes'] + np.array(
                    [dx, dy, dx, dy], np.float32)
            return results
        rng = results.setdefault('_rng', np.random.RandomState())
        boxes = results.get('gt_bboxes', np.zeros((0, 4), np.float32))
        for _ in range(100):
            scale = self.ratios[rng.randint(len(self.ratios))]
            th = int(self.crop_size[0] * scale)
            tw = int(self.crop_size[1] * scale)
            hb = self._get_border(self.border, h)
            wb = self._get_border(self.border, w)
            cx = rng.randint(wb, max(w - wb, wb + 1))
            cy = rng.randint(hb, max(h - hb, hb + 1))
            canvas, (dx, dy), patch = self._crop_paste(img, cy, cx, th, tw)
            if len(boxes):
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                keep = ((centers[:, 0] > patch[0]) &
                        (centers[:, 1] > patch[1]) &
                        (centers[:, 0] < patch[2]) &
                        (centers[:, 1] < patch[3]))
                if not keep.any():
                    continue
            else:
                keep = np.zeros((0,), bool)
            results['img'] = canvas
            results['img_shape'] = canvas.shape
            if len(boxes):
                new = boxes[keep] + np.array([dx, dy, dx, dy], np.float32)
                new[:, 0::2] = np.clip(new[:, 0::2], 0, tw)
                new[:, 1::2] = np.clip(new[:, 1::2], 0, th)
                results['gt_bboxes'] = new
                if 'gt_labels' in results:
                    results['gt_labels'] = results['gt_labels'][keep]
                if 'gt_masks' in results:
                    results['gt_masks'] = [
                        _shift_segm(m, dx, dy)
                        for m, k in zip(results['gt_masks'], keep) if k]
            return results
        return results


@PIPELINES.register_module()
class DefaultFormatBundle:
    """Leaves the results as they are: the tensors are packed by
    ``formatting.format_sample``."""

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class Collect:
    """Records the reference's key selection and drops nothing: static
    formatting collects a fixed set of fields later."""

    def __init__(self, keys=(), meta_keys=()):
        self.keys = tuple(keys)
        self.meta_keys = tuple(meta_keys)

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class ImageToTensor:
    """Leaves the results as they are (the image stays numpy HWC)."""

    def __init__(self, keys=('img',)):
        self.keys = tuple(keys)

    def __call__(self, results: Dict) -> Dict:
        return results


class Compose:
    """Apply transforms (objects, or config dicts built through
    ``PIPELINES``) in order; a transform returning None ends the chain."""

    def __init__(self, transforms: Sequence):
        self.transforms = [PIPELINES.build(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, results: Dict) -> Optional[Dict]:
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results
