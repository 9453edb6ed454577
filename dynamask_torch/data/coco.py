"""COCO dataset: annotation index, static batching, evaluation (port of
``dynamask_tpu/data/coco.py``).

A json index without pycocotools, the reference's ``_parse_ann_info``
semantics (crowd boxes become ignore boxes, labels remap to contiguous
0..79), orientation groups for the sampler, precomputed proposals from a
``proposal_file`` (JAX ``coco.py:81-120``), and ``results2json`` + the
COCO-protocol evaluator, the class-agnostic ``proposal`` AR and
``proposal_fast``'s direct recall (JAX ``coco.py:229-260, :318``).
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.class_names import DEEPFASHION_CLASSES
from ..core.mean_ap import eval_recalls
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
                 classes: Optional[Sequence[str]] = None,
                 proposal_file: Optional[str] = None,
                 max_proposals: int = 1000):
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if img_prefix and not osp.isabs(img_prefix):
                img_prefix = osp.join(data_root, img_prefix)
            if proposal_file and not osp.isabs(proposal_file):
                proposal_file = osp.join(data_root, proposal_file)
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
        # precomputed proposals: a pickled list of (N, 4|5) arrays in the
        # order of the unfiltered images (mmdet's RPN test output), kept by
        # image id so that the filtering below cannot misalign them
        self.max_proposals = max_proposals
        self.proposal_file = proposal_file
        self._proposal_ids = [info['id'] for info in self.img_infos]
        self._proposals = self._read_proposals() if proposal_file else None
        if not test_mode:
            self.img_infos = self._filter_imgs(filter_empty_gt)
        # orientation grouping (reference custom.py:_set_group_flag)
        self.flags = np.array(
            [0 if info['width'] >= info['height'] else 1
             for info in self.img_infos], np.int64)
        self.pipeline = Compose(pipeline)

    def _read_proposals(self) -> Dict[int, np.ndarray]:
        with open(self.proposal_file, 'rb') as f:
            plist = pickle.load(f)
        return {i: np.asarray(p, np.float32)
                for i, p in zip(self._proposal_ids, plist)}

    @property
    def proposals(self) -> Optional[Dict[int, np.ndarray]]:
        """Each image's proposals by image id, from ``proposal_file``
        (None without one), read once in each process."""
        if self._proposals is None and self.proposal_file:
            self._proposals = self._read_proposals()
        return self._proposals

    def __getstate__(self) -> dict:
        # a loader worker reads the proposal file itself: a pickle over the
        # 64 KiB of a pipe would start the spawned workers one at a time
        return dict(self.__dict__, _proposals=None)

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
        results = {'img_info': info, 'img_prefix': self.img_prefix,
                   'img_id': info['id']}
        if self.proposals is not None:
            results['proposals'] = self.proposals[info['id']].copy()
        return results

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
                               with_semantic=self.with_semantic,
                               max_proposals=self.max_proposals)
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

    def fast_eval_recall(self, results: List[Dict],
                         proposal_nums: Sequence[int] = (100, 300, 1000),
                         iou_thrs: Optional[Sequence[float]] = None
                         ) -> np.ndarray:
        """Average recall over ``iou_thrs`` (0.5:0.95 by default) of the
        first n proposals, for each n of ``proposal_nums``, by direct IoU
        matching (JAX ``coco.py:229-260``): a result's ``proposals`` where
        it has them (an RPN's), else its valid dets, by score. The GTs are
        those ``get_ann_info`` keeps."""
        if iou_thrs is None:
            iou_thrs = np.arange(0.5, 0.96, 0.05)
        by_id = {int(r['img_id']): r for r in results}
        gts, props = [], []
        for info in self.img_infos:
            boxes = [a['bbox'] for a in self.coco.img_anns.get(info['id'], [])
                     if not (a.get('iscrowd', 0) or a.get('ignore', 0))
                     and a.get('category_id') in self.cat2label
                     and a['bbox'][2] >= 1 and a['bbox'][3] >= 1
                     and a.get('area', a['bbox'][2] * a['bbox'][3]) > 0]
            b = np.asarray(boxes, np.float32).reshape(-1, 4)
            gts.append(np.concatenate([b[:, :2], b[:, :2] + b[:, 2:]], 1))
            res = by_id.get(info['id'])
            if res is None:
                props.append(np.zeros((0, 5), np.float32))
                continue
            if 'proposals' in res:
                p = np.asarray(res['proposals'], np.float32).reshape(-1, 5)
            else:
                p = np.asarray(res['dets'], np.float32).reshape(-1, 5)[
                    np.asarray(res['valid']).astype(bool)]
            if len(p):
                p = p[np.argsort(-p[:, 4], kind='mergesort')]
            props.append(p)
        return eval_recalls(gts, props, proposal_nums, iou_thrs).mean(axis=1)

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
        """COCO metrics of ``results`` (see :meth:`results2json`); with
        'proposal_fast', ``AR@{100,300,1000}`` by :meth:`fast_eval_recall`."""
        det_json, segm_json = self.results2json(results)
        out = self.evaluate_json(det_json, segm_json, [
            m for m in metric if m != 'proposal_fast'], classwise)
        if 'proposal_fast' in metric:
            nums = (100, 300, 1000)
            ar = self.fast_eval_recall(results, nums)
            out.update({f'AR@{n}': float(a) for n, a in zip(nums, ar)})
        return out

    def evaluate_json(self, det_json: List[dict], segm_json: List[dict],
                      metric: Sequence[str] = ('bbox',),
                      classwise: bool = False) -> Dict[str, float]:
        """The evaluator's stage of :meth:`evaluate`, on the output of
        :meth:`results2json`: 'bbox' and 'segm' give the COCO AP/AR table
        with the metric's prefix, 'proposal' the class-agnostic
        AR@{100,300,1000} table (JAX ``coco.py:318-325``)."""
        unknown = set(metric) - {'bbox', 'segm', 'proposal'}
        if unknown:
            raise KeyError(f'metrics {sorted(unknown)} are not COCO metrics '
                           "of json results ('proposal_fast' reads the "
                           'results themselves: evaluate)')
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
        if 'proposal' in metric:
            # every category as one (cocoEval.params.useCats = 0)
            ev = CocoEvaluator([dict(a, category_id=0) for a in gt_anns],
                               img_ids, [0], 'bbox',
                               max_dets=(100, 300, 1000))
            out.update(ev.evaluate([dict(d, category_id=0)
                                    for d in det_json]))
        return out


@DATASETS.register_module()
class DeepFashionDataset(CocoDataset):
    """DeepFashion in COCO format, its 15 classes (JAX
    ``data/coco.py:339-347``, reference ``datasets/deepfashion.py``)."""
    CLASSES = DEEPFASHION_CLASSES


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
