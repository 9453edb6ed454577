"""The middle-format custom dataset (port of ``dynamask_tpu/data/
custom.py:32-143``, the reference's ``mmdet/datasets/custom.py``): the
annotation file is a json or pickle list of per-image dicts::

    [{'filename': 'a.jpg', 'width': 1280, 'height': 720,
      'ann': {'bboxes': (n, 4) xyxy, 'labels': (n,),
              'bboxes_ignore': (k, 4), 'labels_ignore': (k,)}}, ...]

evaluated by VOC-protocol mAP (``core/mean_ap.py``). The static-shape
formatting is every dataset's (``data/formatting.py``).
"""

from __future__ import annotations

import json
import os.path as osp
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.mean_ap import eval_map
from ..utils.registry import DATASETS
from .formatting import format_sample
from .transforms import Compose


class BoxDataset:
    """What the box-annotated datasets share: the data root, the pipeline
    and its static formatting (masks only where the annotations have them),
    the item with its pipeline's
    random draws from ``rng`` (``prepare``), and the per-class (k, 5)
    det lists ``evaluate`` takes from the padded results."""

    CLASSES: Sequence[str] = ()
    # the JAX package's default canvases for these sets
    CANVASES = ((512, 512), (768, 768), (1024, 1024))

    def _setup(self, ann_file, pipeline, img_prefix, data_root, test_mode,
               canvases, max_gts, mask_crop_size, classes) -> str:
        if classes is not None:
            self.CLASSES = tuple(classes)
        if data_root is not None:
            if not osp.isabs(ann_file):
                ann_file = osp.join(data_root, ann_file)
            if img_prefix and not osp.isabs(img_prefix):
                img_prefix = osp.join(data_root, img_prefix)
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.canvases = [tuple(c) for c in canvases or self.CANVASES]
        self.max_gts = max_gts
        self.mask_crop_size = mask_crop_size
        self.pipeline = Compose(pipeline)
        return ann_file

    @classmethod
    def classes_for(cls, cfg: dict) -> Optional[Tuple[str, ...]]:
        return tuple(cfg.get('classes') or cls.CLASSES)

    def __len__(self) -> int:
        return len(self.img_infos)

    def pre_pipeline(self, idx: int) -> Dict:
        return {'img_info': self.img_infos[idx],
                'img_prefix': self.img_prefix, 'img_id': idx}

    def sample_id(self, idx: int) -> int:
        """A result's ``img_id``: the dataset index, which ``evaluate``
        reads back."""
        return idx

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.prepare(idx)

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None
                ) -> Dict[str, np.ndarray]:
        results = self.pre_pipeline(idx)
        if rng is not None:
            results['_rng'] = rng
        if not self.test_mode:
            results['ann_info'] = self.get_ann_info(idx)
        results = self.pipeline(results)
        masks = results.get('gt_masks')
        if masks is not None and (not masks or masks[0] is None):
            results.pop('gt_masks')         # a box-only set
        sample = format_sample(results, self.canvases, self.max_gts,
                               self.mask_crop_size)
        sample['img_id'] = np.array(self.sample_id(idx), np.int64)
        return sample

    def det_lists(self, results: List[Dict]):
        """Per result, per class its valid dets (k, 5), and each result's
        annotations."""
        dets, anns = [], []
        for res in results:
            d = np.asarray(res['dets'])
            labels = np.asarray(res['labels'])
            valid = np.asarray(res['valid']).astype(bool)
            dets.append([d[valid & (labels == c)]
                         for c in range(max(len(self.CLASSES), 1))])
            anns.append(self.get_ann_info(int(res['img_id'])))
        return dets, anns

    def _classwise_table(self, per_class: List[Dict]) -> None:
        width = max((len(n) for n in self.CLASSES), default=8)
        print('\n--- per-class AP ---')
        for name, r in zip(self.CLASSES, per_class):
            print(f'{name:<{width}}  gts {r["num_gts"]:5d}  dets '
                  f'{r["num_dets"]:6d}  recall {float(r["recall"]):.3f}  '
                  f'ap {r["ap"]:.3f}')


@DATASETS.register_module()
class CustomDataset(BoxDataset):
    def __init__(self, ann_file: str, pipeline: Sequence[dict],
                 img_prefix: str = '', data_root: Optional[str] = None,
                 test_mode: bool = False, filter_empty_gt: bool = True,
                 canvases: Optional[Sequence[Tuple[int, int]]] = None,
                 max_gts: int = 100, mask_crop_size: int = 128,
                 classes: Optional[Sequence[str]] = None):
        ann_file = self._setup(ann_file, pipeline, img_prefix, data_root,
                               test_mode, canvases, max_gts, mask_crop_size,
                               classes)
        self.data_infos = self.load_annotations(ann_file)
        if not test_mode:
            # images under 32 px, and without GT boxes under
            # filter_empty_gt, are left out
            self.data_infos = [
                info for info in self.data_infos
                if min(info.get('width', 33), info.get('height', 33)) >= 32
                and not (filter_empty_gt and
                         len(info.get('ann', {}).get('bboxes', ())) == 0)]
        self.flags = np.array(
            [0 if i.get('width', 1) / max(i.get('height', 1), 1) > 1 else 1
             for i in self.data_infos], np.int64)
        self.img_infos = [dict(id=i, file_name=info['filename'],
                               width=info.get('width', 0),
                               height=info.get('height', 0))
                          for i, info in enumerate(self.data_infos)]

    @staticmethod
    def load_annotations(ann_file: str) -> List[Dict]:
        if ann_file.endswith(('.pkl', '.pickle')):
            with open(ann_file, 'rb') as f:
                return pickle.load(f)
        with open(ann_file) as f:
            return json.load(f)

    def get_ann_info(self, idx: int) -> Dict:
        ann = dict(self.data_infos[idx].get('ann', {}))
        boxes = np.asarray(ann.get('bboxes', ()), np.float32).reshape(-1, 4)
        return dict(
            bboxes=boxes,
            labels=np.asarray(ann.get('labels', ()), np.int64).reshape(-1),
            bboxes_ignore=np.asarray(ann.get('bboxes_ignore', ()),
                                     np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(ann.get('labels_ignore', ()),
                                     np.int64).reshape(-1),
            masks=ann.get('masks', [None] * len(boxes)))

    def evaluate(self, results: List[Dict], metric=('mAP',),
                 iou_thr: float = 0.5,
                 classwise: bool = False) -> Dict[str, float]:
        """VOC 'area' mAP at ``iou_thr`` (JAX ``custom.py:130-143``)."""
        dets, anns = self.det_lists(results)
        mAP, per_class = eval_map(dets, anns, iou_thr=iou_thr, mode='area')
        if classwise:
            self._classwise_table(per_class)
        return {'mAP': mAP}
