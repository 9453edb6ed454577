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

from ..core.bbox_transforms import bbox2result
from ..data.coco import dataset_spec
from ..data.formatting import format_sample
from ..data.transforms import Compose
from ..engine.checkpoint import load_params_only
from ..models.builder import build_detector
from ..utils.config import Config
from .test import TEST_KEYS, make_test_fn

def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  device=None, seed: int = 0,
                  init_std: Optional[float] = None) -> torch.nn.Module:
    """Build the config's detector on ``device`` (default ``cuda``, raising
    without a GPU unless ``device='cpu'``). ``checkpoint`` is a port or
    mmdet ``state_dict`` file, a training checkpoint, the training run's
    ``latest`` pointer or its work_dir; without one the weights come from
    ``seed``.

    The model carries ``cfg``, ``CLASSES`` (the checkpoint's ``meta``
    classes, else :func:`config_classes`), the ``canvases`` of the
    image-level API (the config's test set's, COCO's without one: the JAX
    package always takes COCO's, which no Cityscapes image fits, ROADMAP.md
    queue 3) and, when the config has ``data.test``, its test ``pipeline``
    without the file loading step."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_detector(config.model, config.get('train_cfg'),
                           config.get('test_cfg'), device=device, seed=seed,
                           init_std=init_std)
    classes = None
    if checkpoint is not None:
        classes = load_params_only(checkpoint, model).get('CLASSES')
    test = (config.get('data') or {}).get('test')
    names, model.canvases = dataset_spec(test or {})
    model.cfg = config
    model.CLASSES = tuple(classes or config_classes(
        names, model.roi_head.num_classes))
    model.pipeline = Compose(
        [t for t in test['pipeline'] if t['type'] != 'LoadImageFromFile']
    ) if test else None
    return model


def config_classes(names: Optional[Sequence[str]],
                   num_classes: int) -> Tuple[str, ...]:
    """The class names when no checkpoint carries them: the test set's
    ``names`` (:func:`~dynamask_torch.data.coco.dataset_spec`), or
    ``class_{i}`` where there are none or they are not ``num_classes``
    long (an LVIS set, whose names only its json holds). The JAX package
    falls back to COCO's 80 names whatever the head's classes, so a label
    past 79 has no list to go in: ROADMAP.md, queue 3."""
    if names is None or len(names) != num_classes:
        names = [f'class_{i}' for i in range(num_classes)]
    return tuple(names)


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
    batch = {k: torch.from_numpy(sample[k])[None] for k in TEST_KEYS}
    ori_h, ori_w = img.shape[:2]
    ch, cw = -(-ori_h // 32) * 32, -(-ori_w // 32) * 32
    out = make_test_fn(model, (ch, cw), _mask_thr(model))(batch)
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
    ch, cw = batch['image'].shape[1:3]
    return make_test_fn(model, (ch, cw), _mask_thr(model))(batch)


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
