"""Inference entry points (port of ``init_detector``, ``inference_detector``
and ``show_result`` of ``dynamask_tpu/apis/inference.py``).

``inference_detector`` takes an image (a file path or a BGR ``ndarray``),
runs the config's test pipeline on the host and returns the reference's
``(bbox_results, segm_results)``; given a preprocessed batch (a ``dict`` of
tensors), it returns the padded device outputs instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..core.bbox_transforms import bbox2result
from ..data.coco import COCO_CLASSES
from ..data.formatting import format_sample
from ..data.transforms import Compose
from ..engine.checkpoint import load_params_only
from ..models.builder import build_detector
from ..utils.config import Config
from .test import TEST_KEYS, paste_epilogue

# the static canvases of the image-level API (orientation buckets of the
# 1333x800 resize), as the JAX package's Detector has them
CANVASES = ((800, 1344), (1344, 800), (1344, 1344))


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  device=None, seed: int = 0,
                  init_std: Optional[float] = None) -> torch.nn.Module:
    """Build the config's detector on ``device`` (default ``cuda``, raising
    without a GPU unless ``device='cpu'``). ``checkpoint`` is a port or
    mmdet ``state_dict`` file, a training checkpoint, the training run's
    ``latest`` pointer or its work_dir; without one the weights come from
    ``seed``.

    The model carries ``cfg``, ``CLASSES`` (the checkpoint's ``meta``
    classes, else COCO's), the ``canvases`` of the image-level API and, when
    the config has ``data.test``, its test ``pipeline`` without the file
    loading step."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_detector(config.model, config.get('train_cfg'),
                           config.get('test_cfg'), device=device, seed=seed,
                           init_std=init_std)
    classes = None
    if checkpoint is not None:
        classes = load_params_only(checkpoint, model).get('CLASSES')
    model.cfg = config
    model.CLASSES = tuple(classes or COCO_CLASSES)
    model.canvases = CANVASES
    test = (config.get('data') or {}).get('test')
    model.pipeline = Compose(
        [t for t in test['pipeline'] if t['type'] != 'LoadImageFromFile']
    ) if test else None
    return model


def _mask_thr(model: torch.nn.Module) -> float:
    cfg = getattr(model, 'cfg', None)
    rcnn = ((cfg.get('test_cfg') or {}).get('rcnn') or {}) if cfg else {}
    return rcnn.get('mask_thr_binary', 0.5)


def inference_detector(model: torch.nn.Module,
                       img: Union[str, np.ndarray, Dict[str, torch.Tensor]]):
    """Detect on one image -> ``(bbox_results, segm_results)``: per class a
    (k, 5) float32 array [x1, y1, x2, y2, score] and a list of k bool
    (h, w) masks, in original-image coordinates (reference
    apis/inference.py:inference_detector).

    ``img`` is a file path or a BGR uint8 ``ndarray``, which the model's
    test pipeline resizes, normalises and pads onto one of its canvases;
    masks are pasted on the original extent rounded up to 32.

    Given a preprocessed batch instead (a ``dict`` of ``image`` (B, H, W, 3)
    NHWC, ``img_shape`` (B, 2), ``scale_factor`` (B, 4)), returns the
    padded outputs of ``simple_test`` + device-side paste: dets, labels,
    valid and masks (B, D, H, W) on the input canvas."""
    if isinstance(img, dict):
        return _inference_batch(model, img)
    import cv2
    if model.pipeline is None:
        raise ValueError('the model has no test pipeline: its config lacks '
                         'data.test')
    if isinstance(img, str):
        path, img = img, cv2.imread(img, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
    results = model.pipeline({'img': img, 'img_shape': img.shape,
                              'ori_shape': img.shape})
    sample = format_sample(results, model.canvases)
    dev = model.device
    batch = {k: torch.from_numpy(sample[k])[None].to(dev) for k in TEST_KEYS}
    ori_h, ori_w = img.shape[:2]
    ch, cw = -(-ori_h // 32) * 32, -(-ori_w // 32) * 32
    with torch.no_grad():
        out = paste_epilogue(model.simple_test(batch), ch, cw,
                             _mask_thr(model))
    dets, labels, valid = (out[k][0].cpu().numpy()
                           for k in ('dets', 'labels', 'valid'))
    masks = out['masks'][0, :, :ori_h, :ori_w].cpu().numpy()
    num_classes = len(model.CLASSES)
    bbox_results = bbox2result(dets[:, :4], dets[:, 4], labels, valid,
                               num_classes)
    segm_results: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    for d in np.nonzero(valid)[0]:
        segm_results[int(labels[d])].append(masks[d])
    return bbox_results, segm_results


def _inference_batch(model: torch.nn.Module,
                     batch: Dict[str, torch.Tensor]) -> Dict:
    """``simple_test`` + device-side paste on a preprocessed batch; masks
    land on the input canvas, thresholded at the config's
    ``mask_thr_binary`` (0.5 without a config)."""
    dev = model.device
    batch = {k: v.to(dev) for k, v in batch.items()}
    ch, cw = batch['image'].shape[1:3]
    with torch.no_grad():
        out = model.simple_test(batch)
        with record_function('paste'):
            result = paste_epilogue(out, ch, cw, _mask_thr(model))
    if 'msm_routing' in out:
        result['msm_routing'] = out['msm_routing']
    return result


def show_result(img: np.ndarray, result: Tuple, classes: Sequence[str],
                score_thr: float = 0.3,
                out_file: Optional[str] = None) -> np.ndarray:
    """Draw boxes, class names and mask overlays on a copy of the BGR
    ``img`` with cv2 (reference base.py:show_result); written to
    ``out_file`` if given."""
    import cv2
    bbox_results, segm_results = (result if isinstance(result, tuple)
                                  else (result, None))
    canvas = img.copy()
    rng = np.random.RandomState(42)
    for cls, dets in enumerate(bbox_results):
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        for i, det in enumerate(dets):
            x1, y1, x2, y2, score = det
            if score < score_thr:
                continue
            cv2.rectangle(canvas, (int(x1), int(y1)), (int(x2), int(y2)),
                          color, 2)
            cv2.putText(canvas, f'{classes[cls]} {score:.2f}',
                        (int(x1), int(y1) - 4), cv2.FONT_HERSHEY_SIMPLEX,
                        0.5, color, 1)
            if segm_results is not None and i < len(segm_results[cls]):
                mask = segm_results[cls][i].astype(bool)
                canvas[mask] = canvas[mask] * 0.5 + np.array(color) * 0.5
    if out_file:
        cv2.imwrite(out_file, canvas)
    return canvas
