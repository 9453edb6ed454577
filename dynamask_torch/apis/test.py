"""Det -> canvas mask epilogue (port of ``_paste_epilogue``,
``dynamask_tpu/apis/test.py:22-33``)."""

from __future__ import annotations

from typing import Dict

from ..ops.paste import paste_masks


def paste_epilogue(out: Dict, ch: int, cw: int, mask_thr: float) -> Dict:
    """Paste each det's mask probabilities onto a (ch, cw) canvas and
    threshold them on the device -> dets, labels, valid, masks
    (B, D, ch, cw) bool."""
    b, d = out['dets'].shape[:2]
    probs = out['mask_probs']
    boxes = out['dets'][..., :4].reshape(b * d, 4)
    pasted = paste_masks(probs.reshape(b * d, *probs.shape[2:]), boxes, ch, cw)
    masks = (pasted >= mask_thr).reshape(b, d, ch, cw)
    return {'dets': out['dets'], 'labels': out['labels'],
            'valid': out['det_valid'], 'masks': masks}
