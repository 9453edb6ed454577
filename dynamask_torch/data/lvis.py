"""LVIS v0.5 / v1 datasets and federated evaluation (port of
``dynamask_tpu/data/lvis.py:28-150``, the reference's
``mmdet/datasets/lvis.py``).

Class names and category ids come from the annotation json (the reference
hardcodes the same 1203 names in ``mmdet/utils/lvis_v1_categories.py``),
and an image's file name from its ``coco_url`` when it has none. The JAX
package resolves both only when it filters the images, which a test-mode
dataset never does: there its classes stay COCO's 80 and its images have
no file name. The port resolves them in every mode (ROADMAP.md, queue 3).

LVIS's protocol beside COCO's:

* at most 300 detections an image, the highest scored (``MAX_DETS_LVIS``);
* federated annotations: a det is kept only if its category is among the
  image's annotated (positive), ``not_exhaustive_category_ids`` or
  ``neg_category_ids`` categories; the others are ignored, not counted as
  false positives;
* AP by category frequency: ``mAP_r``, ``mAP_c``, ``mAP_f`` (rare, common,
  frequent), -1.0 for a band with no category.
"""

from __future__ import annotations

import itertools
from collections import defaultdict
from typing import Dict, List, Sequence

from ..utils.registry import DATASETS
from .coco import CocoDataset
from .cocoeval import CocoEvaluator


class LvisEvaluator(CocoEvaluator):
    """The COCO-protocol core with LVIS's 300-det cap and federated
    ignoring; ``img_neg_cats`` / ``img_seen_cats`` map an image id to its
    negative / annotated-or-not-exhaustive category ids, ``cat_freq`` a
    category id to 'r', 'c' or 'f'."""

    MAX_DETS_LVIS = 300

    def __init__(self, gt_anns, img_ids, cat_ids, iou_type='bbox',
                 img_sizes=None, img_neg_cats=None, img_seen_cats=None,
                 cat_freq=None):
        super().__init__(gt_anns, img_ids, cat_ids, iou_type, img_sizes)
        self.img_neg_cats = img_neg_cats or {}
        self.img_seen_cats = img_seen_cats or {}
        self.cat_freq = cat_freq or {}

    def evaluate(self, det_anns: List[dict]) -> Dict[str, float]:
        by_img = defaultdict(list)
        for d in det_anns:
            by_img[d['image_id']].append(d)
        kept = []
        for img, dets in by_img.items():
            seen = self.img_seen_cats.get(img)
            neg = self.img_neg_cats.get(img, set())
            dets = sorted(dets, key=lambda d: -d['score'])
            for d in dets[:self.MAX_DETS_LVIS]:
                if seen is None or d['category_id'] in seen or \
                        d['category_id'] in neg:
                    kept.append(d)
        stats = super().evaluate(kept)
        if self.cat_freq:
            # each band's categories evaluated on their own
            for band in ('r', 'c', 'f'):
                cats = {c for c in self.cat_ids
                        if self.cat_freq.get(c) == band}
                if not cats:
                    stats[f'mAP_{band}'] = -1.0
                    continue
                sub = LvisEvaluator(
                    [a for a in itertools.chain.from_iterable(
                        self.gt_by_key.values()) if a['category_id'] in cats],
                    self.img_ids, [c for c in self.cat_ids if c in cats],
                    self.iou_type, self.img_sizes, self.img_neg_cats,
                    self.img_seen_cats)
                stats[f'mAP_{band}'] = sub.evaluate(
                    [d for d in kept if d['category_id'] in cats])['mAP']
        return stats


@DATASETS.register_module()
class LVISV1Dataset(CocoDataset):
    """LVIS v1 (reference ``lvis.py:LVISV1Dataset``)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault('filter_empty_gt', True)
        self._lvis_classes_from_json = kwargs.get('classes') is None
        super().__init__(*args, **kwargs)
        if self.test_mode:   # no _filter_imgs: resolve here
            self._resolve_json_index()

    @classmethod
    def classes_for(cls, cfg: dict):
        """``cfg``'s ``classes``, else None: the names are in the annotation
        json, which is not parsed (hundreds of MB) only for them."""
        return tuple(cfg['classes']) if cfg.get('classes') else None

    def _resolve_json_index(self) -> None:
        """Classes and category ids from the json (unless given), each
        image's file name from its ``coco_url`` where it has none."""
        if self._lvis_classes_from_json:
            cats = sorted(self.coco.cats.items())
            self.CLASSES = tuple(c['name'] for _, c in cats)
            self.cat_ids = [cid for cid, _ in cats]
            self.cat2label = {cid: i for i, cid in enumerate(self.cat_ids)}
        for info in self.img_infos:
            if 'file_name' not in info and 'coco_url' in info:
                info['file_name'] = info['coco_url'].split('/')[-1]

    def _filter_imgs(self, filter_empty_gt, min_size=32):
        self._resolve_json_index()
        return super()._filter_imgs(filter_empty_gt, min_size)

    def _federated_maps(self):
        img_neg, img_seen = {}, {}
        for info in self.img_infos:
            img_neg[info['id']] = set(info.get('neg_category_ids', []))
            seen = set(a['category_id']
                       for a in self.coco.img_anns.get(info['id'], []))
            seen |= set(info.get('not_exhaustive_category_ids', []))
            img_seen[info['id']] = seen
        return img_neg, img_seen

    def _cat_freq(self):
        """'r' / 'c' / 'f' per category: the json's ``frequency``, else from
        its ``image_count`` (< 10 rare, < 100 common)."""
        freq = {}
        for cid, cat in self.coco.cats.items():
            f = cat.get('frequency')
            if f is None:
                n = cat.get('image_count', 0)
                f = 'r' if n < 10 else ('c' if n < 100 else 'f')
            freq[cid] = f
        return freq

    def evaluate_json(self, det_json: List[dict], segm_json: List[dict],
                      metric: Sequence[str] = ('bbox',),
                      classwise: bool = False) -> Dict[str, float]:
        """LVIS metrics for 'bbox' and 'segm' (other names are skipped, as
        in the JAX package), each key with the metric's prefix."""
        img_ids = [i['id'] for i in self.img_infos]
        gt_anns = [a for i in self.img_infos
                   for a in self.coco.img_anns.get(i['id'], [])]
        img_sizes = {i['id']: (i['height'], i['width'])
                     for i in self.img_infos}
        img_neg, img_seen = self._federated_maps()
        freq = self._cat_freq()
        out = {}
        for m in metric:
            if m not in ('bbox', 'segm'):
                continue
            ev = LvisEvaluator(gt_anns, img_ids, self.cat_ids, m,
                               img_sizes=img_sizes, img_neg_cats=img_neg,
                               img_seen_cats=img_seen, cat_freq=freq)
            dets = det_json if m == 'bbox' else segm_json
            for k, v in ev.evaluate(dets).items():
                out[f'{m}_{k}'] = v
            if classwise:
                self._classwise_table(ev, m)
        return out


@DATASETS.register_module()
class LVISV05Dataset(LVISV1Dataset):
    """LVIS v0.5 (reference ``lvis.py:LVISV05Dataset``): the same schema
    with 1230 categories."""


# the reference registry's name
DATASETS.register_module(name='LvisDataset', module=LVISV05Dataset)
