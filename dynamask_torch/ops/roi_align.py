"""RoIAlign: FPN level routing, single-level and multilevel crops.

Port of ``dynamask_tpu/ops/roi_align.py`` (``map_roi_levels`` :217,
``roi_align`` :159, ``multilevel_roi_align`` :230, ``simple_roi_align``
:303). Semantics are mmcv ``RoIAlign(aligned=True)`` with a STATIC
``sampling_ratio`` (2 for the box and mask extracts, 1 for the SFM and MSM
crops), not mmcv's adaptive 0 (``roi_align.py:14-18``): samples outside
``[-1, extent]`` add zero, inside ones clamp to the edge
(``_bilinear_gather``, :46-128).

Every form reduces to one crop of a flat NHWC buffer with per-RoI
``(base, h, w, scale)``, as the XLA multilevel form does
(``roi_align.py:261-300``): :func:`roi_align_flat`, a
``torch.autograd.Function`` whose forward is :func:`roi_align_fwd` (kernel
K2, ``csrc/roi_align.cu``) and whose backward is :func:`roi_align_bwd`
(kernel K4, ``csrc/roi_align_bwd.cu``), the gradient of the flat features.
RoIs carry no gradient: the JAX training step detaches proposals
(``dynamask_tpu/models/detectors.py:116-118``) and mask-target RoIs. On a
CPU tensor the plain PyTorch versions beside the kernels run. Features are
NHWC at these public functions, as in the JAX package; a ``channels_last``
NCHW map viewed with ``permute(0, 2, 3, 1)`` is contiguous NHWC and costs no
copy.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build
from .deform_conv import _refuse_grad


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """``floor(log2(sqrt(wh) / finest_scale + 1e-6))`` clamped to
    ``[0, num_levels - 1]`` (int64)."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0]).clamp(min=0) *
                       (rois[:, 3] - rois[:, 1]).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def roi_align_fwd_plain(flat: torch.Tensor, rois: torch.Tensor,
                        base: torch.Tensor, hs: torch.Tensor,
                        ws: torch.Tensor, scales: torch.Tensor,
                        out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch form of K2: the same samples as a gather.

    ``flat`` (rows, C); ``rois`` (N, 4); ``base`` (N,) int64 first row of
    each RoI's plane; ``hs``/``ws`` (N,) int32 plane extent; ``scales`` (N,)
    float32 coordinate scale. Returns (N, P, P, C)."""
    n, c = rois.shape[0], flat.shape[1]
    p, s = out_size, sampling_ratio
    dev = flat.device
    x1 = rois[:, 0] * scales - 0.5
    y1 = rois[:, 1] * scales - 0.5
    x2 = rois[:, 2] * scales - 0.5
    y2 = rois[:, 3] * scales - 0.5
    roi_w, roi_h = x2 - x1, y2 - y1
    sub = (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None] +
            sub[None, :]).reshape(-1)
    # a tensor divisor keeps ATen's division exact (a scalar one becomes a
    # multiply by its reciprocal), so sample points match K2's bit for bit
    div = torch.full_like(roi_h, float(p))
    ys = y1[:, None] + (roi_h / div)[:, None] * grid[None, :]   # (N, P*s)
    xs = x1[:, None] + (roi_w / div)[:, None] * grid[None, :]
    ps = p * s
    yy = ys[:, :, None].expand(n, ps, ps)
    xx = xs[:, None, :].expand(n, ps, ps)
    hf = hs.float()[:, None, None]
    wf = ws.float()[:, None, None]
    inside = ((yy >= -1.0) & (yy <= hf) & (xx >= -1.0) & (xx <= wf)).float()
    yc = torch.minimum(yy.clamp(min=0.0), hf - 1)
    xc = torch.minimum(xx.clamp(min=0.0), wf - 1)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    ly, lx = yc - y0, xc - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    y0i, x0i = y0.long(), x0.long()
    hl = hs.long()[:, None, None]
    wl = ws.long()[:, None, None]
    y1i = torch.minimum(y0i + 1, hl - 1)
    x1i = torch.minimum(x0i + 1, wl - 1)
    b = base.long()[:, None, None]

    def take(yi, xi):
        return flat[(b + yi * wl + xi).reshape(-1)]

    v = (take(y0i, x0i) * (hy * hx * inside).reshape(-1, 1) +
         take(y0i, x1i) * (hy * lx * inside).reshape(-1, 1) +
         take(y1i, x0i) * (ly * hx * inside).reshape(-1, 1) +
         take(y1i, x1i) * (ly * lx * inside).reshape(-1, 1))
    return v.reshape(n, p, s, p, s, c).mean(dim=(2, 4))


def _check_crop(name, flat, rois, base, hs, ws, scales):
    n = rois.shape[0]
    for arg, t, dt, shape in (
            ('flat', flat, torch.float32, None),
            ('rois', rois, torch.float32, (n, 4)),
            ('base', base, torch.int64, (n,)),
            ('hs', hs, torch.int32, (n,)),
            ('ws', ws, torch.int32, (n,)),
            ('scales', scales, torch.float32, (n,))):
        if t.device != flat.device or t.device.type != 'cuda':
            raise ValueError(f'{name}: {arg} must be on the CUDA device of '
                             f'the features, got {t.device}')
        if t.dtype != dt:
            raise TypeError(f'{name}: {arg} must be {dt}, got {t.dtype}')
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f'{name}: {arg} shape {tuple(t.shape)}, '
                             f'expected {shape}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {arg} must be contiguous')
    if flat.dim() != 2:
        raise ValueError(f'{name}: features must be (rows, C)')


def _launch(lib, fn_name, args, ints, stream, name):
    fn = getattr(_build.load(lib), fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(args) + [ctypes.c_int] * len(
        ints) + [ctypes.c_void_p]
    rc = fn(*[t.data_ptr() for t in args], *ints, stream)
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{rc}')


def roi_align_fwd(flat: torch.Tensor, rois: torch.Tensor, base: torch.Tensor,
                  hs: torch.Tensor, ws: torch.Tensor, scales: torch.Tensor,
                  out_size: int, sampling_ratio: int) -> torch.Tensor:
    """K2 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`roi_align_fwd_plain`. Carries no
    gradient: :func:`roi_align_flat` is the differentiable entry."""
    _refuse_grad('roi_align_fwd', flat)
    if flat.device.type == 'cpu':
        return roi_align_fwd_plain(flat, rois, base, hs, ws, scales,
                                   out_size, sampling_ratio)
    _check_crop('roi_align_fwd', flat, rois, base, hs, ws, scales)
    n, c = rois.shape[0], flat.shape[1]
    out = torch.empty((n, out_size, out_size, c), dtype=torch.float32,
                      device=flat.device)
    if out.numel() == 0:
        return out
    _launch('roi_align', 'roi_align_fwd_f32',
            (flat, rois, base, hs, ws, scales, out),
            (n, c, out_size, sampling_ratio),
            torch.cuda.current_stream(flat.device).cuda_stream,
            'roi_align_fwd')
    roi_align_fwd.launches += 1
    return out


roi_align_fwd.launches = 0


def roi_align_bwd_plain(d_out: torch.Tensor, rows: int, rois: torch.Tensor,
                        base: torch.Tensor, hs: torch.Tensor,
                        ws: torch.Tensor, scales: torch.Tensor,
                        out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch form of K4: the gradient (rows, C) of the flat
    features from ``d_out`` (N, P, P, C), as autograd of
    :func:`roi_align_fwd_plain` (the crop is linear in the features)."""
    flat = torch.zeros(rows, d_out.shape[-1], device=d_out.device,
                       requires_grad=True)
    with torch.enable_grad():
        out = roi_align_fwd_plain(flat, rois, base, hs, ws, scales, out_size,
                                  sampling_ratio)
    return torch.autograd.grad(out, flat, d_out)[0]


def roi_align_bwd(d_out: torch.Tensor, rows: int, rois: torch.Tensor,
                  base: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                  scales: torch.Tensor, out_size: int,
                  sampling_ratio: int) -> torch.Tensor:
    """K4 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`roi_align_bwd_plain`. The result is
    summed with fp32 atomics, so its last bits vary from run to run."""
    if d_out.device.type == 'cpu':
        return roi_align_bwd_plain(d_out, rows, rois, base, hs, ws, scales,
                                   out_size, sampling_ratio)
    n, c = rois.shape[0], d_out.shape[-1]
    d_flat = torch.zeros((rows, c), dtype=torch.float32, device=d_out.device)
    _check_crop('roi_align_bwd', d_flat, rois, base, hs, ws, scales)
    if (d_out.dtype != torch.float32 or not d_out.is_contiguous() or
            tuple(d_out.shape) != (n, out_size, out_size, c)):
        raise ValueError(f'roi_align_bwd: d_out must be a contiguous float32 '
                         f'{(n, out_size, out_size, c)} tensor, got '
                         f'{tuple(d_out.shape)} {d_out.dtype}')
    if d_out.numel() == 0:
        return d_flat
    _launch('roi_align_bwd', 'roi_align_bwd_f32',
            (d_out, rois, base, hs, ws, scales, d_flat),
            (n, c, out_size, sampling_ratio),
            torch.cuda.current_stream(d_out.device).cuda_stream,
            'roi_align_bwd')
    roi_align_bwd.launches += 1
    return d_flat


roi_align_bwd.launches = 0


class _RoIAlignFlat(torch.autograd.Function):
    """K2 forward, K4 backward; the gradient of the features only."""

    @staticmethod
    def forward(ctx, flat, rois, base, hs, ws, scales, out_size,
                sampling_ratio):
        ctx.save_for_backward(rois, base, hs, ws, scales)
        ctx.conf = (flat.shape[0], out_size, sampling_ratio)
        return roi_align_fwd(flat, rois, base, hs, ws, scales, out_size,
                             sampling_ratio)

    @staticmethod
    def backward(ctx, d_out):
        rows, p, s = ctx.conf
        d_flat = roi_align_bwd(d_out.contiguous().float(), rows,
                               *ctx.saved_tensors, p, s)
        return d_flat, None, None, None, None, None, None, None


def roi_align_flat(flat: torch.Tensor, rois: torch.Tensor,
                   base: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                   scales: torch.Tensor, out_size: int,
                   sampling_ratio: int) -> torch.Tensor:
    """Differentiable crop of the flat features (arguments as
    :func:`roi_align_fwd_plain`); ``rois`` are taken as constants."""
    return _RoIAlignFlat.apply(flat, rois.detach().float().contiguous(),
                               base.contiguous(), hs.contiguous(),
                               ws.contiguous(), scales.contiguous(), out_size,
                               sampling_ratio)


def _flat_planes(features: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, List[int]]:
    """Concatenate NHWC planes into one (rows, C) buffer; returns it with
    each level's first row."""
    c = features[0].shape[-1]
    flats = [f.reshape(-1, c) for f in features]
    offsets = [0]
    for f in flats[:-1]:
        offsets.append(offsets[-1] + f.shape[0])
    flat = flats[0] if len(flats) == 1 else torch.cat(flats, 0)
    return flat.contiguous().float(), offsets


def roi_align(features: torch.Tensor, rois: torch.Tensor,
              roi_batch: torch.Tensor, out_size: int, spatial_scale: float,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """Single-level RoIAlign of NHWC ``features`` (B, H, W, C) ->
    (N, P, P, C). Only the aligned rules are ported: no config of the port
    uses legacy RoIAlign."""
    if not aligned:
        raise NotImplementedError('roi_align: aligned=False (legacy '
                                  'RoIAlign) is not ported')
    h, w = features.shape[1:3]
    n = rois.shape[0]
    flat, _ = _flat_planes([features])
    dev = features.device
    base = roi_batch.long() * (h * w)
    hs = torch.full((n,), h, dtype=torch.int32, device=dev)
    ws = torch.full((n,), w, dtype=torch.int32, device=dev)
    scales = torch.full((n,), spatial_scale, dtype=torch.float32, device=dev)
    return roi_align_flat(flat, rois, base, hs, ws, scales, out_size,
                          sampling_ratio)


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         roi_batch: torch.Tensor, out_size: int,
                         featmap_strides: Tuple[int, ...],
                         sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """FPN-routed RoIAlign over NHWC levels (B, Hl, Wl, C), one kernel
    launch for the whole pyramid -> (N, P, P, C)."""
    num_levels = len(features)
    assert num_levels == len(featmap_strides)
    dev = features[0].device
    flat, offsets = _flat_planes(features)
    lvl = map_roi_levels(rois, num_levels, finest_scale)
    heights = torch.tensor([f.shape[1] for f in features], dtype=torch.int32,
                           device=dev)
    widths = torch.tensor([f.shape[2] for f in features], dtype=torch.int32,
                          device=dev)
    h_per, w_per = heights[lvl], widths[lvl]
    base = (torch.tensor(offsets, dtype=torch.int64, device=dev)[lvl] +
            roi_batch.long() * h_per.long() * w_per.long())
    scales = (1.0 / torch.tensor(featmap_strides, dtype=torch.float32,
                                 device=dev))[lvl]
    return roi_align_flat(flat, rois, base, h_per, w_per, scales, out_size,
                          sampling_ratio)


def simple_roi_align(features: torch.Tensor, rois: torch.Tensor,
                     roi_batch: torch.Tensor, out_size: int,
                     spatial_scale: float,
                     sampling_ratio: int = 1) -> torch.Tensor:
    """Aligned single-level RoIAlign of the semantic crops (mmcv
    SimpleRoIAlign), one sample per bin by default."""
    return roi_align(features, rois, roi_batch, out_size, spatial_scale,
                     sampling_ratio=sampling_ratio)
