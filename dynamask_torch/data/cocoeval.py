"""COCO-protocol detection/segmentation evaluation (pure numpy; port of
``dynamask_tpu/data/cocoeval.py``, the same matching, interpolation and
stats keys).

Native replacement for pycocotools' COCOeval as the reference uses it
(reference: mmdet/datasets/coco.py:365-562 ``evaluate``): AP@[.5:.95],
AP50/75, APs/m/l, AR@[1,10,100], per-image greedy matching in score order
with crowd-region ignore semantics, 101-point precision interpolation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .mask_codec import segm_iou

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNGS = {
    'all': (0.0, 1e10),
    'small': (0.0, 32.0 ** 2),
    'medium': (32.0 ** 2, 96.0 ** 2),
    'large': (96.0 ** 2, 1e10),
}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                  iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise IoU of xywh boxes; IoF for crowd gts (maskUtils.iou)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix1 = np.maximum(dx1[:, None], gx1[None, :])
    iy1 = np.maximum(dy1[:, None], gy1[None, :])
    ix2 = np.minimum(dx2[:, None], gx2[None, :])
    iy2 = np.minimum(dy2[:, None], gy2[None, :])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    denom = np.where(crowd, d_area, d_area + g_area - inter)
    return np.where(denom > 0, inter / np.maximum(denom, 1e-12), 0.0)


class CocoEvaluator:
    """Evaluate detection results against COCO-format ground truth.

    Args:
        gt_anns: list of gt annotation dicts (COCO schema: image_id,
            category_id, bbox xywh, area, iscrowd, optional segmentation).
        img_ids: all image ids (images with no gt still count).
        cat_ids: category ids to evaluate.
        iou_type: 'bbox' or 'segm'.
        max_dets: detection-count cutoffs. Default (1, 10, 100) gives the
            standard AP/AR table; (100, 300, 1000) reproduces the reference
            'proposal' metric (coco.py:450-490, cocoEval.params.maxDets).
    """

    def __init__(self, gt_anns: List[dict], img_ids: Sequence[int],
                 cat_ids: Sequence[int], iou_type: str = 'bbox',
                 img_sizes: Optional[Dict[int, Sequence[int]]] = None,
                 iou_thrs: Optional[Sequence[float]] = None,
                 max_dets: Optional[Sequence[int]] = None):
        assert iou_type in ('bbox', 'segm')
        self.iou_type = iou_type
        self.max_dets = (tuple(sorted(max_dets)) if max_dets is not None
                         else MAX_DETS)
        # custom thresholds support tools/coco_error_analysis.py (e.g. a
        # single 0.1 threshold for localization-error APs)
        self.iou_thrs = np.asarray(iou_thrs if iou_thrs is not None
                                   else IOU_THRS)
        self.img_ids = list(img_ids)
        self.cat_ids = list(cat_ids)
        self.img_sizes = img_sizes or {}
        self.gt_by_key = defaultdict(list)
        for ann in gt_anns:
            self.gt_by_key[(ann['image_id'], ann['category_id'])].append(ann)

    def evaluate(self, det_anns: List[dict]) -> Dict[str, float]:
        det_by_key = defaultdict(list)
        for d in det_anns:
            det_by_key[(d['image_id'], d['category_id'])].append(d)

        t = len(self.iou_thrs)
        k_num = len(self.cat_ids)
        a_num = len(AREA_RNGS)
        m_num = len(self.max_dets)
        # accumulate per (cat, area, maxdet): match matrices over images
        precision = -np.ones((t, len(REC_THRS), k_num, a_num, m_num))
        recall = -np.ones((t, k_num, a_num, m_num))

        for ki, cat in enumerate(self.cat_ids):
            per_img = []
            for img in self.img_ids:
                gts = self.gt_by_key.get((img, cat), [])
                dets = det_by_key.get((img, cat), [])
                if not gts and not dets:
                    continue
                per_img.append(self._match_image(dets, gts,
                                                 self.img_sizes.get(img)))
            if not per_img:
                continue
            for ai, (aname, arng) in enumerate(AREA_RNGS.items()):
                for mi, maxdet in enumerate(self.max_dets):
                    self._accumulate(per_img, arng, maxdet, precision, recall,
                                     ki, ai, mi)

        stats = self._summarize(precision, recall)
        # per-category AP@[.5:.95] (area=all, top maxdet) for the reference's
        # classwise table (coco.py:496-516)
        ai = list(AREA_RNGS).index('all')
        self.per_class_ap = {}
        for ki, cat in enumerate(self.cat_ids):
            p = precision[:, :, ki, ai, -1]
            p = p[p > -1]
            self.per_class_ap[cat] = float(p.mean()) if p.size else float('nan')
        return stats

    # ---------------------------------------------------------------- match

    def _match_image(self, dets: List[dict], gts: List[dict],
                     img_size: Optional[Sequence[int]] = None):
        """Greedy IoU matching in score order at all thresholds (COCOeval
        evaluateImg)."""
        dets = sorted(dets, key=lambda d: -d['score'])[:max(self.max_dets)]
        iscrowd = [bool(g.get('iscrowd', 0)) for g in gts]
        if self.iou_type == 'bbox':
            d_boxes = np.asarray([d['bbox'] for d in dets], np.float64
                                 ).reshape(-1, 4)
            g_boxes = np.asarray([g['bbox'] for g in gts], np.float64
                                 ).reshape(-1, 4)
            ious = bbox_iou_xywh(d_boxes, g_boxes, iscrowd)
        else:
            if img_size is None:
                raise ValueError('segm eval requires img_sizes={id: (h, w)}')
            ious = segm_iou([d['segmentation'] for d in dets],
                            [g['segmentation'] for g in gts], iscrowd,
                            int(img_size[0]), int(img_size[1]))

        g_areas = np.asarray([g.get('area', g['bbox'][2] * g['bbox'][3])
                              for g in gts], np.float64)
        d_areas = np.asarray([d['bbox'][2] * d['bbox'][3] for d in dets],
                             np.float64)
        d_scores = np.asarray([d['score'] for d in dets], np.float64)
        g_ignore_base = np.asarray(iscrowd, bool) | \
            np.asarray([bool(g.get('ignore', 0)) for g in gts], bool)

        return {
            'ious': ious, 'g_areas': g_areas, 'd_areas': d_areas,
            'd_scores': d_scores, 'g_crowd': np.asarray(iscrowd, bool),
            'g_ignore_base': g_ignore_base,
        }

    def _accumulate(self, per_img, arng, maxdet, precision, recall,
                    ki, ai, mi):
        t = len(self.iou_thrs)
        all_scores, all_matched, all_ignored = [], [], []
        n_gt = 0
        for rec in per_img:
            g_ignore = rec['g_ignore_base'] | (rec['g_areas'] < arng[0]) | \
                (rec['g_areas'] > arng[1])
            n_gt += int((~g_ignore).sum())
            d = min(maxdet, len(rec['d_scores']))
            if d == 0:
                continue
            ious = rec['ious'][:d]
            dt_m = np.zeros((t, d), np.int64)       # 0 unmatched, 1 matched
            dt_ig = np.zeros((t, d), bool)
            gt_m = -np.ones((t, len(g_ignore)), np.int64)
            # greedy: gts sorted ignore-last (COCOeval sorts gtind by _ignore)
            order = np.argsort(g_ignore, kind='stable')
            for ti, thr in enumerate(self.iou_thrs):
                for di in range(d):
                    best, best_iou = -1, min(thr, 1 - 1e-10)
                    for gi in order:
                        if gt_m[ti, gi] >= 0 and not rec['g_crowd'][gi]:
                            continue
                        # stop at ignored gts if already matched a real one
                        if best > -1 and not g_ignore[best] and g_ignore[gi]:
                            break
                        if ious[di, gi] < best_iou:
                            continue
                        best_iou = ious[di, gi]
                        best = gi
                    if best == -1:
                        continue
                    gt_m[ti, best] = di
                    dt_m[ti, di] = 1
                    dt_ig[ti, di] = g_ignore[best]
            # unmatched dets outside the area range are ignored
            d_out = (rec['d_areas'][:d] < arng[0]) | \
                (rec['d_areas'][:d] > arng[1])
            dt_ig |= (dt_m == 0) & d_out[None, :]
            all_scores.append(rec['d_scores'][:d])
            all_matched.append(dt_m)
            all_ignored.append(dt_ig)

        if n_gt == 0:
            return
        if not all_scores:
            recall[:, ki, ai, mi] = 0
            precision[:, :, ki, ai, mi] = 0
            return
        scores = np.concatenate(all_scores)
        matched = np.concatenate(all_matched, axis=1)
        ignored = np.concatenate(all_ignored, axis=1)
        order = np.argsort(-scores, kind='mergesort')
        matched = matched[:, order]
        ignored = ignored[:, order]

        tps = (matched == 1) & ~ignored
        fps = (matched == 0) & ~ignored
        tp_cum = np.cumsum(tps, axis=1).astype(np.float64)
        fp_cum = np.cumsum(fps, axis=1).astype(np.float64)
        for ti in range(t):
            tp, fp = tp_cum[ti], fp_cum[ti]
            rc = tp / n_gt
            pr = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
            # precision envelope (monotone decreasing)
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, REC_THRS, side='left')
            q = np.zeros(len(REC_THRS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[ti, :, ki, ai, mi] = q

    # ------------------------------------------------------------- summarize

    def _summarize(self, precision, recall) -> Dict[str, float]:
        def ap(iou=None, area='all', maxdet=100):
            ai = list(AREA_RNGS).index(area)
            mi = self.max_dets.index(maxdet)
            p = precision[:, :, :, ai, mi]
            if iou is not None:
                hit = np.where(np.isclose(self.iou_thrs, iou))[0]
                if hit.size == 0:   # custom-threshold runs lack this slice
                    return -1.0
                p = p[[hit[0]]]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def ar(area='all', maxdet=100):
            ai = list(AREA_RNGS).index(area)
            mi = self.max_dets.index(maxdet)
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        if self.max_dets != MAX_DETS:
            # proposal-style table (reference 'proposal' metric_items)
            top = max(self.max_dets)
            stats = {f'AR@{m}': ar(maxdet=m) for m in self.max_dets}
            stats[f'AR_s@{top}'] = ar(area='small', maxdet=top)
            stats[f'AR_m@{top}'] = ar(area='medium', maxdet=top)
            stats[f'AR_l@{top}'] = ar(area='large', maxdet=top)
            return stats

        return {
            'mAP': ap(), 'mAP_50': ap(iou=0.5), 'mAP_75': ap(iou=0.75),
            'mAP_s': ap(area='small'), 'mAP_m': ap(area='medium'),
            'mAP_l': ap(area='large'),
            'AR@1': ar(maxdet=1), 'AR@10': ar(maxdet=10),
            'AR@100': ar(maxdet=100),
            'AR_s@100': ar(area='small'), 'AR_m@100': ar(area='medium'),
            'AR_l@100': ar(area='large'),
        }
