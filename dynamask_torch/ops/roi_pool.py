"""RoIPool (the quantised max) and deformable RoI pooling, plain PyTorch
(port of ``dynamask_tpu/ops/roi_pool.py``: ``roi_pool`` :29,
``deform_roi_pooling`` :66, ``multilevel_deform_roi_pool`` :125, which
are XLA in the JAX package and so have no hand kernel here).

``roi_pool`` forms its bin edges as JAX's compiled function does: the
division by the bin count is a multiply by its fp32 reciprocal fused with
the add, so a bin edge that falls on a whole cell may land one cell on.

``deform_roi_pooling`` keeps JAX's conventions: the RoI's corner at
``r * scale - 0.5``, its extent ``r2 - r1 + 1`` (at least 0.1), each of
the ``out x out`` bins averaging ``sample_per_part``² bilinear samples
shifted by the bin's offset (``(dy, dx)`` in the last axis, times
``trans_std`` and the RoI's extent), the sum divided by the count of
samples strictly inside the map, while the bilinear weights keep a
sample within one pixel of the map (mmcv's rule, JAX
``roi_align.py:70``).

``multilevel_deform_roi_pool`` computes each RoI on the level it is routed
to only (JAX pools every level and keeps the routed one: the same result
and gradient). The samples of all RoIs are gathered from one flat buffer
of every level's rows, a chunk of RoIs at a time; under autograd each
chunk is recomputed in the backward rather than kept.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from .roi_align import map_roi_levels

# RoIs a gather chunk: 128 RoIs of 49 bins, 16 samples and 4 corners at
# 256 channels gather 0.4 GB in fp32
ROI_CHUNK = 128


def roi_pool(features: torch.Tensor, rois: torch.Tensor,
             roi_batch: torch.Tensor, out_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) NHWC + (N, 4) RoIs -> (N, out, out, C): the quantised
    max over each bin's cells of the rounded RoI (Fast R-CNN's RoIPool),
    an empty bin 0."""
    b, h, w, c = features.shape
    s = out_size
    r = torch.round(rois.float() * spatial_scale)
    x1, y1 = r[:, 0], r[:, 1]
    rw = torch.clamp(r[:, 2] - r[:, 0] + 1, min=1.0)
    rh = torch.clamp(r[:, 3] - r[:, 1] + 1, min=1.0)
    bi = torch.arange(s, dtype=torch.float32, device=rois.device)
    recip = torch.tensor(1.0 / s, dtype=torch.float32).double()

    def edge(lo, i, extent, rnd):
        # JAX's compiled form: the division by the bin count a multiply by
        # its fp32 reciprocal, fused with the add (one rounding)
        t = (i[None] * extent[:, None]).double()
        return rnd((lo[:, None].double() + t * recip).float())

    ys = edge(y1, bi, rh, torch.floor)
    ye = edge(y1, bi + 1, rh, torch.ceil)
    xs = edge(x1, bi, rw, torch.floor)
    xe = edge(x1, bi + 1, rw, torch.ceil)
    iy = torch.arange(h, dtype=torch.float32, device=rois.device)
    ix = torch.arange(w, dtype=torch.float32, device=rois.device)
    my = (iy >= ys[..., None]) & (iy < ye[..., None])         # (N, s, H)
    mx = (ix >= xs[..., None]) & (ix < xe[..., None])         # (N, s, W)
    neg = torch.finfo(torch.float32).min
    feats = features[roi_batch.long()].float()                # (N, H, W, C)
    per_row = torch.where(my[:, :, :, None, None], feats[:, None],
                          neg).amax(2)                        # (N, s, W, C)
    out = torch.where(mx[:, None, :, :, None], per_row[:, :, None],
                      neg).amax(3)                            # (N, s, s, C)
    return torch.where(out <= neg / 2, 0.0, out).to(features.dtype)


def _sample_grid(rois: torch.Tensor, scale: torch.Tensor,
                 offsets: Optional[torch.Tensor], out_size: int,
                 sample_per_part: int, trans_std: float):
    """Each RoI's sample coordinates (N, s, sp, s, sp) in its map's
    pixels, y and x, as JAX ``deform_roi_pooling`` forms them."""
    n, s, sp = rois.shape[0], out_size, sample_per_part
    r = rois * scale[:, None]
    x1 = r[:, 0] - 0.5
    y1 = r[:, 1] - 0.5
    rw = torch.clamp(r[:, 2] - r[:, 0] + 1.0, min=0.1)
    rh = torch.clamp(r[:, 3] - r[:, 1] + 1.0, min=0.1)
    bin_w, bin_h = rw / s, rh / s
    sub_w, sub_h = bin_w / sp, bin_h / sp
    bi = torch.arange(s, dtype=rois.dtype, device=rois.device)
    si = torch.arange(sp, dtype=rois.dtype, device=rois.device)
    ys = (y1[:, None, None] + bi[None, :, None] * bin_h[:, None, None] +
          (si[None, None, :] + 0.5) * sub_h[:, None, None])   # (N, s, sp)
    xs = (x1[:, None, None] + bi[None, :, None] * bin_w[:, None, None] +
          (si[None, None, :] + 0.5) * sub_w[:, None, None])
    shape = (n, s, sp, s, sp)
    yy = ys[:, :, :, None, None].expand(shape)
    xx = xs[:, None, None, :, :].expand(shape)
    if offsets is not None:
        dy = offsets[..., 0] * trans_std * rh[:, None, None]   # (N, s, s)
        dx = offsets[..., 1] * trans_std * rw[:, None, None]
        yy = yy + dy[:, :, None, :, None]
        xx = xx + dx[:, :, None, :, None]
    return yy, xx


def _pool(flat: torch.Tensor, base: torch.Tensor, hs: torch.Tensor,
          ws: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor
          ) -> torch.Tensor:
    """The bins' averages (N, s, s, C) of the samples (N, s, sp, s, sp) of
    each RoI's plane (rows ``base`` onwards of ``flat``, ``hs`` x ``ws``)."""
    shape = (-1, 1, 1, 1, 1)
    h, w = hs.to(yy.dtype).view(shape), ws.to(yy.dtype).view(shape)
    inside = (yy >= -1.0) & (yy <= h) & (xx >= -1.0) & (xx <= w)
    y = torch.minimum(torch.clamp(yy, min=0.0), h - 1)
    x = torch.minimum(torch.clamp(xx, min=0.0), w - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    ly, lx = y - y0, x - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    hi, wi = hs.view(shape), ws.view(shape)
    y0i, x0i = y0.long(), x0.long()
    y1i = torch.minimum(y0i + 1, hi - 1)
    x1i = torch.minimum(x0i + 1, wi - 1)
    row = base.view(shape)
    vals = 0
    for yi, xi, wt in ((y0i, x0i, hy * hx), (y0i, x1i, hy * lx),
                       (y1i, x0i, ly * hx), (y1i, x1i, ly * lx)):
        idx = (row + yi * wi + xi).reshape(-1)
        wt = (wt * inside).to(flat.dtype).reshape(-1, 1)
        vals = vals + flat.index_select(0, idx) * wt
    c = flat.shape[1]
    vals = vals.view(*yy.shape, c).sum((2, 4))                # (N, s, s, C)
    cnt = ((yy > -1.0) & (yy < h) & (xx > -1.0) & (xx < w)).to(
        vals.dtype).sum((2, 4)).clamp(min=1.0)
    return vals / cnt[..., None]


def deform_roi_pooling(features: torch.Tensor, rois: torch.Tensor,
                       roi_batch: torch.Tensor,
                       offsets: Optional[torch.Tensor], out_size: int = 7,
                       spatial_scale: float = 1.0, sample_per_part: int = 4,
                       trans_std: float = 0.1) -> torch.Tensor:
    """(B, H, W, C) NHWC + (N, 4) RoIs (+ (N, out, out, 2) ``(dy, dx)``
    offsets, None for none) -> (N, out, out, C)."""
    b, h, w, c = features.shape
    n = rois.shape[0]
    dev = rois.device
    scale = torch.full((n,), spatial_scale, dtype=rois.dtype, device=dev)
    return _chunked(features.reshape(b * h * w, c), roi_batch.long() * h * w,
                    torch.full((n,), h, device=dev),
                    torch.full((n,), w, device=dev), rois, scale, offsets,
                    out_size, sample_per_part, trans_std)


def _chunked(flat, base, hs, ws, rois, scale, offsets, out_size,
             sample_per_part, trans_std):
    def chunk(flat, rois, offsets, base, hs, ws, scale):
        yy, xx = _sample_grid(rois, scale, offsets, out_size,
                              sample_per_part, trans_std)
        return _pool(flat, base, hs, ws, yy, xx)

    outs = []
    for i in range(0, rois.shape[0], ROI_CHUNK):
        sl = slice(i, i + ROI_CHUNK)
        args = (flat, rois[sl], None if offsets is None else offsets[sl],
                base[sl], hs[sl], ws[sl], scale[sl])
        if torch.is_grad_enabled() and (flat.requires_grad or (
                offsets is not None and offsets.requires_grad)):
            outs.append(checkpoint(chunk, *args, use_reentrant=False))
        else:
            outs.append(chunk(*args))
    if not outs:
        return flat.new_zeros((0, out_size, out_size, flat.shape[1]))
    return torch.cat(outs)


def multilevel_deform_roi_pool(features: Sequence[torch.Tensor],
                               rois: torch.Tensor, roi_batch: torch.Tensor,
                               out_size: int, featmap_strides,
                               offsets: Optional[torch.Tensor] = None,
                               finest_scale: int = 56,
                               trans_std: float = 0.1,
                               sample_per_part: int = 4) -> torch.Tensor:
    """FPN-routed deformable RoI pooling of NHWC levels (B, H_l, W_l, C):
    each RoI pooled on its ``map_roi_levels`` level at that level's scale;
    ``offsets`` None pools without offsets."""
    lvl = map_roi_levels(rois, len(features), finest_scale).long()
    flat = torch.cat([f.reshape(-1, f.shape[-1]) for f in features])
    dev = rois.device
    starts, acc = [], 0
    for f in features:
        starts.append(acc)
        acc += f.shape[0] * f.shape[1] * f.shape[2]
    level = lambda vals: torch.tensor(vals, device=dev)[lvl]  # noqa: E731
    hs = level([f.shape[1] for f in features])
    ws = level([f.shape[2] for f in features])
    base = level(starts) + roi_batch.long() * hs * ws
    scale = torch.tensor([1.0 / s for s in featmap_strides],
                         dtype=rois.dtype, device=dev)[lvl]
    return _chunked(flat, base, hs, ws, rois, scale, offsets, out_size,
                    sample_per_part, trans_std)
