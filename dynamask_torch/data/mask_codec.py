"""COCO RLE mask codec and polygon rasterization (port of
``dynamask_tpu/data/mask_codec.py``; numpy + cv2, no pycocotools).

The wire format is COCO's: column-major run lengths that start with a
zero-run, written as 6-bit varint strings with second-order deltas.
``encode_mask``, ``decode_rle``, ``rle_area`` and ``rle_iou`` run the C codec
of :mod:`dynamask_torch.native` (built at first use; a failed build
raises). The numpy functions ``mask_to_rle_counts``, ``rle_counts_to_*``
and ``rle_string_to_counts`` are its plain version: ``encode_mask_plain``
and ``decode_rle_plain`` compose them, and the tests and ``chip_smoke.py``
hold the two against each other byte for byte.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import numpy as np

from ..native import maskc

# the C codec's error codes
_ERRORS = {-1: (MemoryError, 'out of memory in the mask codec'),
           -2: (ValueError, 'negative run length in rle'),
           -3: (ValueError, 'rle does not cover h*w pixels')}


def _check(code: int) -> int:
    if code < 0:
        exc, msg = _ERRORS[code]
        raise exc(msg)
    return code


def _as_bytes(counts) -> bytes:
    return counts.encode('ascii') if isinstance(counts, str) else counts


# -- the plain version (numpy) ------------------------------------------------

def mask_to_rle_counts(mask: np.ndarray) -> np.ndarray:
    """Binary (h, w) mask -> run lengths (column-major, starting with 0s)."""
    flat = np.asarray(mask, np.uint8).flatten(order='F')
    n = flat.size
    if n == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    idx = np.concatenate([[0], change, [n]])
    counts = np.diff(idx)
    if flat[0] == 1:  # runs must start with a zero-run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def rle_counts_to_mask(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total != h * w:
        raise ValueError(f'rle covers {total} pixels, expected {h}*{w}')
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    return flat.reshape((h, w), order='F')


def rle_counts_to_string(counts: Sequence[int]) -> bytes:
    """maskApi.c rleToString: 6-bit varints with continuation bit and
    second-order deltas (x -= cnts[i-2] for i > 2)."""
    counts = [int(c) for c in counts]
    out = bytearray()
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            out.append(ch + 48)
    return bytes(out)


def rle_string_to_counts(s: Union[bytes, str]) -> np.ndarray:
    s = _as_bytes(s)
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def encode_mask_plain(mask: np.ndarray) -> Dict:
    """``encode_mask`` through the numpy functions."""
    h, w = mask.shape
    return {'size': [int(h), int(w)],
            'counts': rle_counts_to_string(
                mask_to_rle_counts(mask)).decode('ascii')}


def decode_rle_plain(rle: Dict) -> np.ndarray:
    """``decode_rle`` of a compressed RLE through the numpy functions."""
    h, w = rle['size']
    return rle_counts_to_mask(rle_string_to_counts(rle['counts']), h, w)


# -- the C codec ----------------------------------------------------------------

def encode_mask(mask: np.ndarray) -> Dict:
    """Binary (h, w) mask -> COCO compressed RLE dict (pycocotools.mask.encode
    equivalent). ``counts`` is an ascii str for json compatibility. A
    column-major (Fortran-ordered) uint8 or bool mask is read in place."""
    h, w = mask.shape
    m = np.asarray(mask)
    m = m.view(np.uint8) if m.dtype == np.bool_ else np.asarray(m, np.uint8)
    m = np.asfortranarray(m)
    lib, out = maskc(), ctypes.c_void_p()
    n = _check(lib.maskc_encode(m.ctypes.data, m.size, ctypes.byref(out)))
    try:
        s = ctypes.string_at(out, n)
    finally:
        lib.maskc_free(out)
    return {'size': [int(h), int(w)], 'counts': s.decode('ascii')}


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO RLE dict (compressed str or uncompressed list) -> (h, w) uint8."""
    h, w = rle['size']
    counts = rle['counts']
    if isinstance(counts, (bytes, str)):
        s = _as_bytes(counts)
        out = np.empty(int(h) * int(w), np.uint8)
        _check(maskc().maskc_decode(s, len(s), int(h), int(w),
                                    out.ctypes.data))
        return out.reshape((h, w), order='F')
    return rle_counts_to_mask(counts, h, w)


def rle_area(rle: Dict) -> int:
    counts = rle['counts']
    if isinstance(counts, (bytes, str)):
        s = _as_bytes(counts)
        return int(_check(maskc().maskc_area(s, len(s))))
    return int(np.asarray(counts, np.int64)[1::2].sum())


def polygons_to_mask(polygons: Sequence[Sequence[float]], h: int,
                     w: int) -> np.ndarray:
    """Rasterize COCO polygons ([[x0, y0, x1, y1, ...], ...]) to (h, w)
    uint8: each polygon filled with rounded vertices, the union over
    polygons (the reference's polygon_to_bitmap, mmcv's cv2 form)."""
    import cv2
    mask = np.zeros((h, w), np.uint8)
    for poly in polygons:
        pts = np.round(np.asarray(poly, np.float64).reshape(-1, 2))
        cv2.fillPoly(mask, [pts.astype(np.int32)], 1)
    return mask


def ann_to_mask(segm, h: int, w: int) -> np.ndarray:
    """COCO annotation 'segmentation' field (polygons or RLE) -> binary mask."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, h, w)
    if isinstance(segm, dict):
        counts = segm['counts']
        if isinstance(counts, list):  # uncompressed RLE
            return rle_counts_to_mask(counts, h, w)
        return decode_rle(segm)
    raise TypeError(type(segm))


def _masks_pairwise_iou(d_masks: List[np.ndarray], g_masks: List[np.ndarray],
                        iscrowd: Sequence[bool]) -> np.ndarray:
    out = np.zeros((len(d_masks), len(g_masks)))
    for j, (gm, crowd) in enumerate(zip(g_masks, iscrowd)):
        g_area = gm.sum()
        for i, dm in enumerate(d_masks):
            inter = np.logical_and(dm, gm).sum()
            d_area = dm.sum()
            denom = d_area if crowd else (d_area + g_area - inter)
            out[i, j] = inter / denom if denom > 0 else 0.0
    return out


def rle_iou(dets: List[Dict], gts: List[Dict],
            iscrowd: Sequence[bool]) -> np.ndarray:
    """Pairwise mask IoU of RLE dicts (pycocotools.mask.iou equivalent):
    for crowd gts the denominator is the det area (IoF). Compressed RLEs are
    compared in the run-length domain by the C codec (maskApi.c rleIou);
    uncompressed ones densely."""
    if not dets or not gts:
        return np.zeros((len(dets), len(gts)))
    if all(isinstance(r['counts'], (bytes, str)) for r in dets + gts):
        d = [_as_bytes(r['counts']) for r in dets]
        g = [_as_bytes(r['counts']) for r in gts]
        dlens = np.asarray([len(s) for s in d], np.int64)
        glens = np.asarray([len(s) for s in g], np.int64)
        crowd = np.asarray([bool(c) for c in iscrowd], np.uint8)
        if len(crowd) != len(g):
            raise ValueError(f'{len(crowd)} iscrowd flags for {len(g)} gts')
        out = np.zeros((len(d), len(g)), np.float64)
        _check(maskc().maskc_iou(
            (ctypes.c_char_p * len(d))(*d), dlens.ctypes.data, len(d),
            (ctypes.c_char_p * len(g))(*g), glens.ctypes.data, len(g),
            crowd.ctypes.data, out.ctypes.data))
        return out
    d_masks = [decode_rle(d).astype(bool) for d in dets]
    g_masks = [decode_rle(g).astype(bool) for g in gts]
    return _masks_pairwise_iou(d_masks, g_masks, iscrowd)


def segm_iou(dets: List, gts: List, iscrowd: Sequence[bool],
             h: int, w: int) -> np.ndarray:
    """Pairwise mask IoU where entries may be RLE dicts OR polygon lists
    (gt annotations keep their original representation); dense, as the
    JAX package computes it."""
    if not dets or not gts:
        return np.zeros((len(dets), len(gts)))
    d_masks = [ann_to_mask(d, h, w).astype(bool) for d in dets]
    g_masks = [ann_to_mask(g, h, w).astype(bool) for g in gts]
    return _masks_pairwise_iou(d_masks, g_masks, iscrowd)
