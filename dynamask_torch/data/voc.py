"""Pascal VOC and other XML-annotated sets (port of ``dynamask_tpu/data/
voc.py:27-199``, the reference's ``xml_style.py`` + ``voc.py``): one XML
file per image, difficult objects as ignore boxes, VOC mAP ('11points' for
VOC2007, 'area' otherwise) and proposal recall; ``WIDERFaceDataset``
(:198-200), SSD's face set.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.mean_ap import eval_map, eval_recalls
from ..utils.registry import DATASETS
from .custom import BoxDataset

VOC_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')


@DATASETS.register_module()
class XMLDataset(BoxDataset):
    def __init__(self, ann_file: str, pipeline: Sequence[dict],
                 img_prefix: str = '', data_root: Optional[str] = None,
                 img_subdir: str = 'JPEGImages',
                 ann_subdir: str = 'Annotations',
                 test_mode: bool = False, min_size: Optional[int] = None,
                 canvases: Optional[Sequence[Tuple[int, int]]] = None,
                 max_gts: int = 100, mask_crop_size: int = 128,
                 classes: Optional[Sequence[str]] = None):
        ann_file = self._setup(ann_file, pipeline, img_prefix, data_root,
                               test_mode, canvases, max_gts, mask_crop_size,
                               classes)
        self.img_subdir = img_subdir
        self.ann_subdir = ann_subdir
        self.min_size = min_size
        self.cat2label = {c: i for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            self.img_ids = [line.strip() for line in f if line.strip()]
        self.img_infos = []
        for img_id in self.img_ids:
            w = h = 0
            root = self._xml(img_id)
            size = root.find('size') if root is not None else None
            if size is not None:
                w = int(size.find('width').text)
                h = int(size.find('height').text)
            self.img_infos.append(dict(
                id=img_id, file_name=osp.join(img_subdir, f'{img_id}.jpg'),
                width=w, height=h))
        self.flags = np.array([0 if i['width'] >= i['height'] else 1
                               for i in self.img_infos], np.int64)

    def _xml(self, img_id: str):
        path = osp.join(self.img_prefix, self.ann_subdir, f'{img_id}.xml')
        return ET.parse(path).getroot() if osp.exists(path) else None

    def get_ann_info(self, idx: int) -> Dict:
        """Boxes (xmin - 1, ymin - 1, xmax, ymax) and labels of the objects
        of the set's classes; difficult ones, and any under ``min_size``,
        as ignore boxes."""
        boxes, labels, boxes_ig, labels_ig = [], [], [], []
        root = self._xml(self.img_infos[idx]['id'])
        for obj in (root.findall('object') if root is not None else ()):
            name = obj.find('name').text
            if name not in self.cat2label:
                continue
            diff = obj.find('difficult')
            diff = int(diff.text) if diff is not None else 0
            bb = obj.find('bndbox')
            box = [float(bb.find('xmin').text) - 1,
                   float(bb.find('ymin').text) - 1,
                   float(bb.find('xmax').text), float(bb.find('ymax').text)]
            if self.min_size and (box[2] - box[0] < self.min_size or
                                  box[3] - box[1] < self.min_size):
                diff = 1
            (boxes_ig if diff else boxes).append(box)
            (labels_ig if diff else labels).append(self.cat2label[name])
        return dict(
            bboxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=np.asarray(boxes_ig, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(labels_ig, np.int64),
            masks=[None] * len(boxes))

    def evaluate(self, results: List[Dict], metric=('mAP',),
                 iou_thr: float = 0.5, proposal_nums=(100, 300, 1000),
                 classwise: bool = False) -> Dict[str, float]:
        """'mAP' (``bbox`` is its alias, the CLI's default) and 'recall' of
        ``proposal_nums`` proposals at each of ``iou_thr`` (JAX
        ``voc.py:134-192``)."""
        if isinstance(metric, str):
            metric = [metric]
        metric = ['mAP' if m == 'bbox' else m for m in metric]
        bad = [m for m in metric if m not in ('mAP', 'recall')]
        if bad:
            raise KeyError(f'metric {bad} is not supported for VOC-style '
                           "datasets (use 'mAP' or 'recall')")
        dets, anns = self.det_lists(results)
        out: Dict[str, float] = {}
        if 'mAP' in metric:
            mode = ('11points' if getattr(self, 'year', 2012) == 2007
                    else 'area')
            thr = iou_thr if isinstance(iou_thr, float) else float(iou_thr[0])
            out['mAP'], per_class = eval_map(dets, anns, iou_thr=thr,
                                             mode=mode)
            if classwise:
                self._classwise_table(per_class)
        if 'recall' in metric:
            raw = []
            for res in results:
                d = np.asarray(res['dets'])[
                    np.asarray(res['valid']).astype(bool)]
                raw.append(d[np.argsort(-d[:, 4], kind='mergesort')]
                           if len(d) else d)
            thrs = [iou_thr] if isinstance(iou_thr, float) else list(iou_thr)
            recalls = eval_recalls([a['bboxes'] for a in anns], raw,
                                   proposal_nums, thrs)
            for i, num in enumerate(proposal_nums):
                for j, thr in enumerate(thrs):
                    out[f'recall@{num}@{thr}'] = float(recalls[i, j])
            if recalls.shape[1] > 1:
                for i, num in enumerate(proposal_nums):
                    out[f'AR@{num}'] = float(recalls[i].mean())
        return out


@DATASETS.register_module()
class VOCDataset(XMLDataset):
    CLASSES = VOC_CLASSES

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.year = 2007 if 'VOC2007' in self.img_prefix else 2012


@DATASETS.register_module()
class WIDERFaceDataset(XMLDataset):
    """WIDER FACE in the XML layout (JAX ``voc.py:198-200``): one class."""
    CLASSES = ('face',)
