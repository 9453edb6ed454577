"""VOC-style mean AP and proposal recall, numpy (port of
``dynamask_tpu/core/mean_ap.py``: ``average_precision`` :30,
``eval_map`` :49-124 and ``eval_recalls`` :127-145): per-class greedy
matching at one IoU threshold, 'area' (every point) or '11points'
interpolation, difficult GTs ignored; the recall of the top-n proposals
at each IoU threshold."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-10)


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = 'area') -> float:
    """The area under the interpolated precision-recall curve ('area'), or
    the mean of the best precision at recall 0, 0.1, ..., 1 ('11points')."""
    if mode == 'area':
        mrec = np.concatenate([[0.0], recalls, [1.0]])
        mpre = np.concatenate([[0.0], precisions, [0.0]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == '11points':
        ap = 0.0
        for t in np.arange(0, 1.1, 0.1):
            mask = recalls >= t
            ap += (precisions[mask].max() if mask.any() else 0.0) / 11
        return float(ap)
    raise ValueError(mode)


def eval_map(det_results: List[List[np.ndarray]], annotations: List[Dict],
             iou_thr: float = 0.5,
             mode: str = 'area') -> Tuple[float, List[Dict]]:
    """VOC mAP of ``det_results`` (per image, per class a (k, 5) array)
    against ``annotations`` (per image 'bboxes', 'labels' and optionally
    'bboxes_ignore' / 'labels_ignore', the difficult GTs, which a det may
    match without counting). Returns (mAP over the classes with GTs,
    per class num_gts, num_dets, recall and ap)."""
    num_classes = len(det_results[0])
    eval_results = []
    for cls in range(num_classes):
        scores_all, tp_all, fp_all = [], [], []
        num_gts = 0
        for dets_img, ann in zip(det_results, annotations):
            dets = np.asarray(dets_img[cls]).reshape(-1, 5)
            gt_mask = np.asarray(ann['labels']) == cls
            gts = np.asarray(ann['bboxes']).reshape(-1, 4)[gt_mask]
            ig_labels = np.asarray(ann.get('labels_ignore', []))
            igs = np.asarray(ann.get('bboxes_ignore', np.zeros((0, 4)))
                             ).reshape(-1, 4)
            if len(ig_labels):
                igs = igs[ig_labels == cls]
            num_gts += len(gts)
            dets = dets[np.argsort(-dets[:, 4])]
            matched = np.zeros(len(gts), bool)
            tp = np.zeros(len(dets))
            fp = np.zeros(len(dets))
            ious = _iou_xyxy(dets[:, :4], gts)
            ious_ig = _iou_xyxy(dets[:, :4], igs)
            for i in range(len(dets)):
                best = ious[i].argmax() if len(gts) else -1
                if best >= 0 and ious[i, best] >= iou_thr and \
                        not matched[best]:
                    matched[best] = True
                    tp[i] = 1
                elif len(igs) and ious_ig[i].max() >= iou_thr:
                    pass    # a difficult GT's match: neither TP nor FP
                else:
                    fp[i] = 1
            scores_all.append(dets[:, 4])
            tp_all.append(tp)
            fp_all.append(fp)
        scores = np.concatenate(scores_all) if scores_all else np.zeros(0)
        tp = np.concatenate(tp_all) if tp_all else np.zeros(0)
        fp = np.concatenate(fp_all) if fp_all else np.zeros(0)
        order = np.argsort(-scores)
        tp_cum = np.cumsum(tp[order])
        fp_cum = np.cumsum(fp[order])
        recalls = tp_cum / max(num_gts, 1)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, 1e-10)
        ap = average_precision(recalls, precisions, mode) if num_gts else 0.0
        eval_results.append({
            'num_gts': num_gts, 'num_dets': len(scores),
            'recall': recalls[-1] if len(recalls) else 0.0, 'ap': ap})
    valid = [r['ap'] for r in eval_results if r['num_gts'] > 0]
    return (float(np.mean(valid)) if valid else 0.0), eval_results


def eval_recalls(gts: List[np.ndarray], proposals: List[np.ndarray],
                 proposal_nums: Sequence[int] = (100, 300, 1000),
                 iou_thrs: Sequence[float] = (0.5,)) -> np.ndarray:
    """(len(proposal_nums), len(iou_thrs)) recall: the share of GTs that
    one of their image's first n proposals overlaps at IoU >= thr."""
    out = np.zeros((len(proposal_nums), len(iou_thrs)))
    total_gt = sum(len(g) for g in gts)
    for pi, pn in enumerate(proposal_nums):
        for ti, thr in enumerate(iou_thrs):
            hit = 0
            for g, p in zip(gts, proposals):
                if len(g) == 0:
                    continue
                p_top = p[:pn, :4]
                if len(p_top) == 0:
                    continue
                hit += int((_iou_xyxy(g, p_top).max(axis=1) >= thr).sum())
            out[pi, ti] = hit / max(total_gt, 1)
    return out
