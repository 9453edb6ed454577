"""COCO dataset: annotation index, static batching, evaluation (port of
``dynamask_tpu/data/coco.py``).

A json index without pycocotools, the reference's ``_parse_ann_info``
semantics (crowd boxes become ignore boxes, labels remap to contiguous
0..79), orientation groups for the sampler, and ``results2json`` + the
COCO-protocol evaluator.
"""

from __future__ import annotations

import json
import os.path as osp
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.registry import DATASETS
from .cocoeval import CocoEvaluator
from .dataset_wrappers import WRAPPERS, wrap_dataset
from .formatting import format_sample
from .mask_codec import encode_mask
from .transforms import Compose

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')

# where the parts of the JAX dataset stack that the port lacks are queued
NOT_PORTED = 'not ported yet (ROADMAP.md, queue 1, item 2)'


class CocoIndex:
    """Minimal pycocotools.COCO replacement: json -> indexed lookups."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs = {img['id']: img for img in data.get('images', [])}
        self.cats = {c['id']: c for c in data.get('categories', [])}
        self.img_anns = defaultdict(list)
        for ann in data.get('annotations', []):
            self.img_anns[ann['image_id']].append(ann)

    @property
    def img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    @property
    def cat_ids(self) -> List[int]:
        return list(self.cats.keys())


@DATASETS.register_module()
class CocoDataset:
    CLASSES = COCO_CLASSES
    # the static canvases (orientation buckets of the 1333x800 resize)
    CANVASES = ((800, 1344), (1344, 800), (1344, 1344))

    def __init__(self,
                 ann_file: str,
                 pipeline: Sequence[dict],
                 img_prefix: str = '',
                 data_root: Optional[str] = None,
                 test_mode: bool = False,
                 filter_empty_gt: bool = True,
                 canvases: Optional[Sequence[Tuple[int, int]]] = None,
                 max_gts: int = 100,
                 mask_crop_size: int = 128,
                 with_semantic: bool = False,
                 classes: Optional[Sequence[str]] = None):
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if img_prefix and not osp.isabs(img_prefix):
                img_prefix = osp.join(data_root, img_prefix)
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.canvases = [tuple(c) for c in canvases or self.CANVASES]
        self.max_gts = max_gts
        self.mask_crop_size = mask_crop_size
        # RefineMask's semantic target (gt_semantic) in each sample
        self.with_semantic = with_semantic
        if classes is not None:
            self.CLASSES = tuple(classes)

        self.coco = CocoIndex(ann_file)
        # category ids -> contiguous labels in CLASSES order
        name_to_cat = {c['name']: cid for cid, c in self.coco.cats.items()}
        self.cat_ids = [name_to_cat[n] for n in self.CLASSES
                        if n in name_to_cat]
        self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}

        self.img_infos = [self.coco.imgs[i] for i in self.coco.img_ids]
        if not test_mode:
            self.img_infos = self._filter_imgs(filter_empty_gt)
        # orientation grouping (reference custom.py:_set_group_flag)
        self.flags = np.array(
            [0 if info['width'] >= info['height'] else 1
             for info in self.img_infos], np.int64)
        self.pipeline = Compose(pipeline)

    @classmethod
    def classes_for(cls, cfg: dict) -> Optional[Tuple[str, ...]]:
        """The class names a dataset built from ``cfg`` has, without
        reading its files: ``cfg``'s ``classes``, else the class's own."""
        return tuple(cfg.get('classes') or cls.CLASSES)

    def __len__(self) -> int:
        return len(self.img_infos)

    def _filter_imgs(self, filter_empty_gt: bool, min_size: int = 32):
        out = []
        for info in self.img_infos:
            if min(info['width'], info['height']) < min_size:
                continue
            anns = self.coco.img_anns.get(info['id'], [])
            valid = [a for a in anns if not a.get('iscrowd', 0)
                     and a['category_id'] in self.cat2label
                     and a['bbox'][2] > 1 and a['bbox'][3] > 1]
            if filter_empty_gt and not valid:
                continue
            out.append(info)
        return out

    def get_ann_info(self, idx: int) -> Dict:
        """Parse annotations (reference coco.py:_parse_ann_info)."""
        info = self.img_infos[idx]
        anns = self.coco.img_anns.get(info['id'], [])
        boxes, labels, masks = [], [], []
        boxes_ignore = []
        for ann in anns:
            if ann.get('ignore', False):
                continue
            x, y, bw, bh = ann['bbox']
            if bw < 1 or bh < 1 or ann.get('area', bw * bh) <= 0:
                continue
            box = [x, y, x + bw, y + bh]
            if ann.get('iscrowd', 0):
                boxes_ignore.append(box)
                continue
            if ann['category_id'] not in self.cat2label:
                continue
            boxes.append(box)
            labels.append(self.cat2label[ann['category_id']])
            masks.append(ann.get('segmentation'))
        return dict(
            bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(boxes_ignore, np.float32).reshape(-1, 4),
            masks=masks)

    def pre_pipeline(self, idx: int) -> Dict:
        info = self.img_infos[idx]
        return {'img_info': info, 'img_prefix': self.img_prefix,
                'img_id': info['id']}

    def sample_id(self, idx: int) -> int:
        return int(self.img_infos[idx]['id'])

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.prepare(idx)

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None
                ) -> Dict[str, np.ndarray]:
        """Item ``idx``, the pipeline's random draws (flip, scale) taken
        from ``rng`` (unseeded, one per sample, when None)."""
        results = self.pre_pipeline(idx)
        if rng is not None:
            results['_rng'] = rng
        if not self.test_mode:
            results['ann_info'] = self.get_ann_info(idx)
        results = self.pipeline(results)
        sample = format_sample(results, self.canvases, self.max_gts,
                               self.mask_crop_size,
                               with_semantic=self.with_semantic)
        sample['img_id'] = np.array(self.sample_id(idx), np.int64)
        return sample

    # ----------------------------------------------------------- evaluation

    def results2json(self, results: List[Dict]) -> Tuple[List[dict], List[dict]]:
        """Per-image padded outputs -> COCO det and segm annotation dicts.

        ``results[i]`` holds numpy 'dets' (D, 5) xyxy+score in ORIGINAL
        image coordinates, 'labels' (D,), 'valid' (D,), and optionally
        'masks': D binary (h, w) masks at original resolution, RLE-encoded
        here for the valid dets.
        """
        det_json, segm_json = [], []
        for res in results:
            img_id = int(res['img_id'])
            dets = np.asarray(res['dets'])
            labels = np.asarray(res['labels'])
            valid = np.asarray(res['valid']).astype(bool)
            for d in np.nonzero(valid)[0]:
                x1, y1, x2, y2, score = dets[d]
                entry = {
                    'image_id': img_id,
                    'category_id': self.cat_ids[int(labels[d])],
                    'bbox': [float(x1), float(y1),
                             float(x2 - x1), float(y2 - y1)],
                    'score': float(score),
                }
                det_json.append(entry)
                if 'masks' in res:
                    seg = dict(entry)
                    seg['segmentation'] = encode_mask(res['masks'][d])
                    segm_json.append(seg)
        return det_json, segm_json

    def fast_eval_recall(self, *args, **kwargs):
        raise NotImplementedError(
            f'fast_eval_recall needs core.eval_recalls, {NOT_PORTED}')

    def _classwise_table(self, ev: CocoEvaluator, title: str) -> None:
        """Per-category AP table (reference coco.py:496-516 classwise)."""
        rows = []
        for cat, ap in ev.per_class_ap.items():
            name = self.coco.cats.get(cat, {}).get(
                'name', self.CLASSES[self.cat2label.get(cat, 0)])
            rows.append((name, ap))
        width = max((len(n) for n, _ in rows), default=8)
        print(f'\n--- per-category {title} AP ---')
        for name, ap in rows:
            print(f'{name:<{width}}  {ap:.3f}')

    def evaluate(self, results: List[Dict],
                 metric: Sequence[str] = ('bbox',),
                 classwise: bool = False) -> Dict[str, float]:
        """COCO metrics of ``results`` (see :meth:`results2json`)."""
        det_json, segm_json = self.results2json(results)
        return self.evaluate_json(det_json, segm_json, metric, classwise)

    def evaluate_json(self, det_json: List[dict], segm_json: List[dict],
                      metric: Sequence[str] = ('bbox',),
                      classwise: bool = False) -> Dict[str, float]:
        """The evaluator's stage of :meth:`evaluate`, on the output of
        :meth:`results2json`: 'bbox' and 'segm' give the COCO AP/AR table
        with the metric's prefix."""
        unknown = set(metric) - {'bbox', 'segm'}
        if unknown & {'proposal', 'proposal_fast'}:
            raise NotImplementedError(
                f'the proposal metrics are {NOT_PORTED}')
        if unknown:
            raise KeyError(f'metrics {sorted(unknown)} are not COCO metrics')
        img_ids = [info['id'] for info in self.img_infos]
        gt_anns = [ann for info in self.img_infos
                   for ann in self.coco.img_anns.get(info['id'], [])
                   if ann['category_id'] in self.cat2label]
        img_sizes = {info['id']: (info['height'], info['width'])
                     for info in self.img_infos}
        out = {}
        if 'bbox' in metric:
            ev = CocoEvaluator(gt_anns, img_ids, self.cat_ids, 'bbox')
            for k, v in ev.evaluate(det_json).items():
                out[f'bbox_{k}'] = v
            if classwise:
                self._classwise_table(ev, 'bbox')
        if 'segm' in metric:
            ev = CocoEvaluator(gt_anns, img_ids, self.cat_ids, 'segm',
                               img_sizes=img_sizes)
            for k, v in ev.evaluate(segm_json).items():
                out[f'segm_{k}'] = v
            if classwise:
                self._classwise_table(ev, 'segm')
        return out


def dataset_spec(cfg: dict) -> Tuple[Optional[Tuple[str, ...]],
                                     List[Tuple[int, int]]]:
    """The class names (None where only the annotation file has them) and
    the canvases of the dataset that ``cfg`` builds, or of the first one
    its wrappers wrap, without reading its files."""
    cfg = dict(cfg)
    while cfg.get('type') in WRAPPERS:
        cfg = dict(cfg['dataset'] if 'dataset' in cfg else cfg['datasets'][0])
    cls = DATASETS.get(cfg.get('type', 'CocoDataset'))
    return (cls.classes_for(cfg),
            [tuple(c) for c in cfg.get('canvases') or cls.CANVASES])


def build_dataset(cfg: dict, default_args: Optional[dict] = None):
    """The dataset of ``cfg`` (``type`` names a ``DATASETS`` entry or a
    wrapper of ``dataset_wrappers``), the keys of ``default_args`` filling
    in what ``cfg`` (each inner dataset's, for a wrapper) lacks."""
    cfg = dict(cfg)
    if cfg.get('type') in WRAPPERS:
        return wrap_dataset(cfg, lambda c: build_dataset(c, default_args))
    t = cfg.pop('type')
    for k, v in (default_args or {}).items():
        cfg.setdefault(k, v)
    return DATASETS.build(dict(type=t, **cfg))
