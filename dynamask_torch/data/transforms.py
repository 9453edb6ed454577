"""Host-side image and annotation transforms, numpy + cv2 (port of
``dynamask_tpu/data/transforms.py``, every transform it registers): the
COCO instance and VOC pipelines' (``configs/_base_/datasets/
coco_instance.py``), ``LoadProposals`` :63-82 for Fast R-CNN's
precomputed proposals, which ``Resize`` and ``RandomFlip`` move with the
image, CornerNet's ``PhotoMetricDistortion`` :291-327 and
``RandomCenterCropPad`` :654-762, SSD's ``Expand`` and
``MinIoURandomCrop``, ``RandomCrop``, ``SegRescale``, ``AutoAugment``,
``MultiScaleFlipAug``, the external packages' ``InstaBoost``, ``Albu`` and
``Corrupt`` (each raises ``ImportError`` at construction without its
package, as JAX's do), ``LoadMultiChannelImageFromFiles``, and the
reference's formatting transforms (``DefaultFormatBundle``, ``Collect``,
``ImageToTensor``, ``ToTensor``, ``ToDataContainer``,
``WrapFieldsToLists`` leave the results as they are: static formatting
collects a fixed set of fields later; ``Transpose`` transposes).

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


# -- the rest of the transforms the JAX package registers (its
# ``transforms.py:247-653, :802-866``) ---------------------------------------

@PIPELINES.register_module()
class RandomCrop:
    """A random ``crop_size`` (h, w) crop, the boxes shifted and clipped to
    it, the GTs left empty dropped with their labels and masks."""

    def __init__(self, crop_size: Tuple[int, int]):
        self.crop_size = tuple(crop_size)

    def __call__(self, results: Dict) -> Dict:
        rng = results.setdefault('_rng', np.random.RandomState())
        img = results['img']
        ch = min(self.crop_size[0], img.shape[0])
        cw = min(self.crop_size[1], img.shape[1])
        y0 = rng.randint(0, img.shape[0] - ch + 1)
        x0 = rng.randint(0, img.shape[1] - cw + 1)
        results['img'] = img[y0:y0 + ch, x0:x0 + cw]
        results['img_shape'] = results['img'].shape
        if 'gt_bboxes' in results:
            shift = np.array([x0, y0, x0, y0], np.float32)
            for key in ('gt_bboxes', 'gt_bboxes_ignore'):
                boxes = results[key] - shift
                boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, cw)
                boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, ch)
                results[key] = boxes
            gt = results['gt_bboxes']
            keep = (gt[:, 2] > gt[:, 0]) & (gt[:, 3] > gt[:, 1])
            results['gt_bboxes'] = gt[keep]
            if 'gt_labels' in results:
                results['gt_labels'] = results['gt_labels'][keep]
            if 'gt_masks' in results:
                results['gt_masks'] = [
                    _shift_segm(m, -x0, -y0)
                    for m, k in zip(results['gt_masks'], keep) if k]
        return results


@PIPELINES.register_module()
class Expand:
    """SSD's expansion: on a draw under ``prob`` the image goes at a random
    place of a canvas ``ratio_range`` times larger, filled with ``mean``
    as given, whatever ``to_rgb`` says (JAX's fill, ROADMAP.md queue 3,
    3ce; mmdet reverses the mean under ``to_rgb``)."""

    def __init__(self, mean=(0, 0, 0), to_rgb=True, ratio_range=(1, 4),
                 prob=0.5):
        self.mean = tuple(mean)
        self.ratio_range = ratio_range
        self.prob = prob

    def __call__(self, results: Dict) -> Dict:
        rng = results.setdefault('_rng', np.random.RandomState())
        if rng.rand() > self.prob:
            return results
        img = results['img']
        h, w = img.shape[:2]
        ratio = rng.uniform(*self.ratio_range)
        eh, ew = int(h * ratio), int(w * ratio)
        y0 = rng.randint(0, eh - h + 1)
        x0 = rng.randint(0, ew - w + 1)
        canvas = np.empty((eh, ew) + img.shape[2:], img.dtype)
        canvas[...] = np.asarray(self.mean, img.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = img
        results['img'] = canvas
        results['img_shape'] = canvas.shape
        if 'gt_bboxes' in results:
            shift = np.array([x0, y0, x0, y0], np.float32)
            for key in ('gt_bboxes', 'gt_bboxes_ignore'):
                results[key] = results[key] + shift
            if 'gt_masks' in results:
                results['gt_masks'] = [_shift_segm(m, x0, y0)
                                       for m in results['gt_masks']]
        return results


@PIPELINES.register_module()
class MinIoURandomCrop:
    """SSD's constrained crop: up to 50 draws of a mode (1: keep the
    image) and a patch; a patch holds when some GT's centre lies in it and
    every such GT keeps at least the mode's share of its own area inside
    it, ``inter / area`` (JAX's rule, ROADMAP.md queue 3, 3cd; mmdet
    thresholds the patch's IoU with each box)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                 min_crop_size=0.3):
        self.sample_modes = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size

    def __call__(self, results: Dict) -> Dict:
        rng = results.setdefault('_rng', np.random.RandomState())
        img = results['img']
        h, w = img.shape[:2]
        boxes = results.get('gt_bboxes', np.zeros((0, 4), np.float32))
        for _ in range(50):
            mode = self.sample_modes[rng.randint(len(self.sample_modes))]
            if mode == 1:
                return results
            new_w = rng.uniform(self.min_crop_size * w, w)
            new_h = rng.uniform(self.min_crop_size * h, h)
            if new_h / new_w < 0.5 or new_h / new_w > 2:
                continue
            left = rng.uniform(0, w - new_w)
            top = rng.uniform(0, h - new_h)
            patch = np.array([left, top, left + new_w, top + new_h])
            if len(boxes):
                cx = (boxes[:, 0] + boxes[:, 2]) / 2
                cy = (boxes[:, 1] + boxes[:, 3]) / 2
                center_in = (cx > patch[0]) & (cy > patch[1]) & \
                    (cx < patch[2]) & (cy < patch[3])
                if not center_in.any():
                    continue
                x1 = np.maximum(boxes[:, 0], patch[0])
                y1 = np.maximum(boxes[:, 1], patch[1])
                x2 = np.minimum(boxes[:, 2], patch[2])
                y2 = np.minimum(boxes[:, 3], patch[3])
                inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
                area = (boxes[:, 2] - boxes[:, 0]) * \
                    (boxes[:, 3] - boxes[:, 1])
                if (inter / np.maximum(area, 1e-6))[center_in].min() < mode:
                    continue
                new_boxes = boxes.copy()
                new_boxes[:, 0::2] = np.clip(new_boxes[:, 0::2], patch[0],
                                             patch[2]) - patch[0]
                new_boxes[:, 1::2] = np.clip(new_boxes[:, 1::2], patch[1],
                                             patch[3]) - patch[1]
                results['gt_bboxes'] = new_boxes[center_in]
                if 'gt_labels' in results:
                    results['gt_labels'] = results['gt_labels'][center_in]
                if 'gt_masks' in results:
                    results['gt_masks'] = [
                        _shift_segm(m, -patch[0], -patch[1])
                        for m, k in zip(results['gt_masks'], center_in)
                        if k]
            results['img'] = img[int(patch[1]):int(patch[3]),
                                 int(patch[0]):int(patch[2])]
            results['img_shape'] = results['img'].shape
            return results
        return results


@PIPELINES.register_module()
class SegRescale:
    """``gt_semantic_seg`` rescaled by ``scale_factor``, nearest."""

    def __init__(self, scale_factor: float = 1.0):
        self.scale_factor = scale_factor

    def __call__(self, results: Dict) -> Dict:
        import cv2
        if 'gt_semantic_seg' in results and self.scale_factor != 1:
            results['gt_semantic_seg'] = cv2.resize(
                results['gt_semantic_seg'], None, fx=self.scale_factor,
                fy=self.scale_factor, interpolation=cv2.INTER_NEAREST)
        return results


@PIPELINES.register_module()
class MultiScaleFlipAug:
    """The reference's test-time augmentation wrapper: for each scale of
    ``img_scale`` (and each flip, with ``flip``) a keep-ratio ``Resize``,
    the flip of the resized image, then ``transforms``; returns the LIST
    of results dicts. (The eval CLI's ``--tta`` builds its augmentations
    itself: ``apis.aug_device_test``.)"""

    def __init__(self, transforms: Sequence[dict], img_scale, flip=False,
                 flip_direction='horizontal'):
        self.transforms = Compose(transforms)
        scales = img_scale if isinstance(img_scale, list) else [img_scale]
        self.img_scales = [tuple(s) for s in scales]
        self.flip = flip

    def __call__(self, results: Dict):
        outs = []
        for scale in self.img_scales:
            for flip in ([False, True] if self.flip else [False]):
                r = dict(results)
                r['img'] = results['img'].copy()
                r['_tta_scale'] = scale
                r['_tta_flip'] = flip
                r = Resize(img_scale=scale, keep_ratio=True)(r)
                if flip:
                    r['img'] = np.ascontiguousarray(r['img'][:, ::-1])
                    r['flip'] = True
                outs.append(self.transforms(r))
        return outs


@PIPELINES.register_module()
class AutoAugment:
    """One of ``policies`` (each a non-empty list of transform configs),
    drawn per sample from ``results['_rng']``, composed on the results."""

    def __init__(self, policies: Sequence[Sequence[Dict]]):
        if not (isinstance(policies, (list, tuple)) and policies and all(
                isinstance(p, (list, tuple)) and p for p in policies)):
            raise ValueError('AutoAugment: policies must be a non-empty '
                             'list of non-empty lists of transform dicts')
        self.policies = [Compose(list(p)) for p in policies]

    def __call__(self, results: Dict) -> Optional[Dict]:
        rng = results.setdefault('_rng', np.random.RandomState())
        return self.policies[rng.randint(len(self.policies))](results)

    def __repr__(self):
        return f'{self.__class__.__name__}(policies={len(self.policies)})'


@PIPELINES.register_module()
class InstaBoost:
    """Instance copy-paste augmentation over the external
    ``instaboostfast`` package, imported at construction: without it this
    raises ``ImportError``, as JAX's does."""

    def __init__(self, action_candidate=('normal', 'horizontal', 'skip'),
                 action_prob=(1, 0, 0), scale=(0.8, 1.2), dx=15, dy=15,
                 theta=(-1, 1), color_prob=0.5, hflag=False,
                 aug_ratio=0.5):
        try:
            import instaboostfast as instaboost
        except ImportError:
            raise ImportError(
                'InstaBoost needs the "instaboostfast" package, a lazy '
                'dependency as in the reference '
                '(mmdet/datasets/pipelines/instaboost.py)')
        self.cfg = instaboost.InstaBoostConfig(
            action_candidate, action_prob, scale, dx, dy, theta,
            color_prob, hflag)
        self.instaboost = instaboost
        self.aug_ratio = aug_ratio

    def __call__(self, results: Dict) -> Dict:
        rng = results.setdefault('_rng', np.random.RandomState())
        if rng.uniform() > self.aug_ratio:
            return results
        anns = results.get('_coco_anns')
        if not anns:
            return results
        anns, img = self.instaboost.get_new_data(anns, results['img'],
                                                 self.cfg, background=None)
        results['img'] = img
        results['_coco_anns'] = anns
        return results


@PIPELINES.register_module()
class Corrupt:
    """Image corruption over the external ``imagecorruptions`` package,
    imported at construction: without it this raises ``ImportError``, as
    JAX's does."""

    def __init__(self, corruption: str, severity: int = 1):
        try:
            from imagecorruptions import corrupt  # noqa: F401
        except ImportError:
            raise ImportError(
                'Corrupt needs the "imagecorruptions" package, a lazy '
                'dependency as in the reference (pipelines/transforms.py)')
        self.corruption = corruption
        self.severity = severity

    def __call__(self, results: Dict) -> Dict:
        from imagecorruptions import corrupt
        results['img'] = corrupt(
            results['img'].astype(np.uint8),
            corruption_name=self.corruption, severity=self.severity)
        return results


@PIPELINES.register_module()
class Albu:
    """Albumentations over the external ``albumentations`` package,
    imported at construction: without it this raises ``ImportError``, as
    JAX's does. Boxes go as pascal_voc tuples; with ``bbox_params``'
    ``label_fields`` the annotations albumentations drops are dropped
    with their labels and masks."""

    def __init__(self, transforms, bbox_params=None, keymap=None,
                 update_pad_shape=False, skip_img_without_anno=False):
        try:
            import albumentations
            from albumentations import Compose as AlbuCompose
        except ImportError:
            raise ImportError(
                'Albu needs the "albumentations" package, a lazy '
                'dependency as in the reference (pipelines/transforms.py)')
        self.filter_lost_elements = False
        if bbox_params is not None:
            bp = dict(bbox_params)
            if 'label_fields' in bp:
                self.filter_lost_elements = True
                self.origin_label_fields = bp['label_fields']
                bp['label_fields'] = ['idx_mapper']
            bbox_params = albumentations.BboxParams(**bp)
        self.aug = AlbuCompose(
            [self._build(t, albumentations) for t in transforms],
            bbox_params=bbox_params)
        self.keymap = keymap or {'img': 'image', 'gt_bboxes': 'bboxes'}
        self.keymap_back = {v: k for k, v in self.keymap.items()}
        self.update_pad_shape = update_pad_shape
        self.skip_img_without_anno = skip_img_without_anno

    def _build(self, cfg, albumentations):
        cfg = dict(cfg)
        cls = getattr(albumentations, cfg.pop('type'))
        if 'transforms' in cfg:
            cfg['transforms'] = [self._build(c, albumentations)
                                 for c in cfg['transforms']]
        return cls(**cfg)

    def __call__(self, results: Dict) -> Optional[Dict]:
        mapped = {self.keymap.get(k, k): v for k, v in results.items()}
        if 'bboxes' in mapped and isinstance(mapped['bboxes'], np.ndarray):
            mapped['bboxes'] = [tuple(b) for b in mapped['bboxes']]
            if self.filter_lost_elements:
                mapped['idx_mapper'] = list(range(len(mapped['bboxes'])))
        mapped = self.aug(**mapped)
        if 'bboxes' in mapped:
            mapped['bboxes'] = np.asarray(
                mapped['bboxes'], np.float32).reshape(-1, 4)
            if self.filter_lost_elements:
                keep = mapped.pop('idx_mapper')
                for field in self.origin_label_fields:
                    if field in mapped:
                        mapped[field] = np.asarray(
                            [mapped[field][i] for i in range(len(keep))])
                if 'gt_labels' in results:
                    mapped['gt_labels'] = np.asarray(
                        results['gt_labels'])[keep]
                if 'gt_masks' in results:
                    mapped['gt_masks'] = [results['gt_masks'][i]
                                          for i in keep]
                if (not len(mapped['bboxes'])
                        and self.skip_img_without_anno):
                    return None
        out = {self.keymap_back.get(k, k): v for k, v in mapped.items()}
        out['img_shape'] = out['img'].shape
        return out


@PIPELINES.register_module()
class ToTensor(ImageToTensor):
    """Leaves the results as they are (the arrays stay numpy)."""


@PIPELINES.register_module()
class ToDataContainer:
    """Leaves the results as they are (no DataContainer here)."""

    def __init__(self, fields=()):
        self.fields = tuple(fields)

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class Transpose:
    """Each of ``keys`` transposed to ``order``, contiguous: applied for
    real, since later steps see the layout."""

    def __init__(self, keys, order):
        self.keys = tuple(keys)
        self.order = tuple(order)

    def __call__(self, results: Dict) -> Dict:
        for k in self.keys:
            results[k] = np.ascontiguousarray(
                np.transpose(results[k], self.order))
        return results


@PIPELINES.register_module()
class WrapFieldsToLists:
    """Leaves the results as they are (batches here are arrays, not the
    reference's lists of one)."""

    def __call__(self, results: Dict) -> Dict:
        return results


@PIPELINES.register_module()
class LoadMultiChannelImageFromFiles:
    """One image file a channel (``img_info['filename']``, a list),
    stacked on the last axis, read unchanged."""

    def __init__(self, to_float32: bool = False,
                 color_type: str = 'unchanged'):
        self.to_float32 = to_float32

    def __call__(self, results: Dict) -> Dict:
        import cv2
        names = results['img_info']['filename']
        prefix = results.get('img_prefix', '')
        imgs = []
        for name in names:
            path = osp.join(prefix, name)
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise FileNotFoundError(path)
            imgs.append(img)
        img = np.stack(imgs, axis=-1)
        if self.to_float32:
            img = img.astype(np.float32)
        results['filename'] = names
        results['img'] = img
        results['img_shape'] = img.shape
        results['ori_shape'] = img.shape
        return results
