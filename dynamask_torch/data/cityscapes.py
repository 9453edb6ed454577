"""Cityscapes instance segmentation (port of
``dynamask_tpu/data/cityscapes.py:31-77``, the reference's
``mmdet/datasets/cityscapes.py``): COCO-format annotations converted from
gtFine (``tools/convert_datasets/cityscapes.py``), 8 instance classes,
COCO-protocol evaluation, and ``results2txt``, the export the official
cityscapesscripts evaluator reads.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Dict, List

import numpy as np

from ..utils.registry import DATASETS
from .coco import CocoDataset

CITYSCAPES_CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
                      'motorcycle', 'bicycle')

# the official Cityscapes label ids of the 8 instance classes
CITYSCAPES_LABEL_IDS = {
    'person': 24, 'rider': 25, 'car': 26, 'truck': 27, 'bus': 28,
    'train': 31, 'motorcycle': 32, 'bicycle': 33,
}


@DATASETS.register_module()
class CityscapesDataset(CocoDataset):
    CLASSES = CITYSCAPES_CLASSES
    # 2048x1024 images at the (2048, 1024) test scale pad to one landscape
    # canvas
    CANVASES = ((1024, 2048), (2048, 1024))

    def _filter_imgs(self, filter_empty_gt, min_size=32):
        """Images with at least one non-crowd GT of the 8 classes (no size
        rules: every Cityscapes image is 2048x1024)."""
        out = []
        for info in self.img_infos:
            anns = self.coco.img_anns.get(info['id'], [])
            valid = [a for a in anns if not a.get('iscrowd', 0)
                     and a['category_id'] in self.cat2label]
            if filter_empty_gt and not valid:
                continue
            out.append(info)
        return out

    def results2txt(self, results: List[Dict], outfile_prefix: str
                    ) -> List[str]:
        """For each image, ``<stem>.txt`` in ``outfile_prefix`` with one
        ``<png> <labelID> <score>`` line per valid det, and each det's mask
        as ``<stem>_<slot>_<class>.png`` (0/255, written with cv2).
        Returns the txt paths."""
        import cv2
        os.makedirs(outfile_prefix, exist_ok=True)
        by_id = {info['id']: info for info in self.img_infos}
        files = []
        for res in results:
            info = by_id[int(res['img_id'])]
            stem = osp.splitext(osp.basename(info['file_name']))[0]
            lines = []
            valid = np.asarray(res['valid']).astype(bool)
            for d in np.nonzero(valid)[0]:
                cls_name = self.CLASSES[int(res['labels'][d])]
                score = float(res['dets'][d, 4])
                png = f'{stem}_{d}_{cls_name}.png'
                mask = np.asarray(res['masks'][d], np.uint8) * 255
                cv2.imwrite(osp.join(outfile_prefix, png), mask)
                lines.append(
                    f'{png} {CITYSCAPES_LABEL_IDS[cls_name]} {score:.6f}')
            txt = osp.join(outfile_prefix, f'{stem}.txt')
            with open(txt, 'w') as f:
                f.write('\n'.join(lines))
            files.append(txt)
        return files
