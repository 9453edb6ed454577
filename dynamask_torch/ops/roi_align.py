"""RoIAlign: FPN level routing, single-level and multilevel crops.

Port of ``dynamask_tpu/ops/roi_align.py`` (``map_roi_levels`` :217,
``roi_align`` :159, ``multilevel_roi_align`` :230, ``simple_roi_align``
:303, ``generic_roi_align`` :320). Semantics are mmcv ``RoIAlign(aligned=True)`` with a STATIC
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

The crops keep the features' type, fp32 or bf16, as the JAX forms do
(``roi_align.py:105-107``): each kernel has an instance of each. A bf16
crop is computed in fp32 from the widened features and rounded once; the
bf16 backward reads a bf16 crop gradient, sums into fp32 and rounds the
feature gradient to bf16 once at the end. RoIs, scales and plane indices
are the same for both.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from . import _build
from .deform_conv import (BF16, DTYPES, MIN_BLOCKS, REDUCE_VEC, VEC_BYTES,
                          _aligned, _count, _refuse_grad)


def map_roi_levels(rois: torch.Tensor, num_levels: int,
                   finest_scale: int = 56) -> torch.Tensor:
    """``floor(log2(sqrt(wh) / finest_scale + 1e-6))`` clamped to
    ``[0, num_levels - 1]`` (int64)."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0]).clamp(min=0) *
                       (rois[:, 3] - rois[:, 1]).clamp(min=0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


def _roi_axes(rois: torch.Tensor, scales: torch.Tensor, out_size: int):
    """Per RoI, the first coordinate and the bin size of each axis, aligned
    (the half-pixel shift): ((y1, bin_h), (x1, bin_w))."""
    x1 = rois[:, 0] * scales - 0.5
    y1 = rois[:, 1] * scales - 0.5
    x2 = rois[:, 2] * scales - 0.5
    y2 = rois[:, 3] * scales - 0.5
    # a tensor divisor keeps ATen's division exact (a scalar one becomes a
    # multiply by its reciprocal), so sample points match K2's bit for bit
    div = torch.full_like(y1, float(out_size))
    return (y1, (y2 - y1) / div), (x1, (x2 - x1) / div)


def roi_axis_samples(lo: torch.Tensor, bin_size: torch.Tensor,
                     extent: torch.Tensor, out_size: int,
                     sampling_ratio: int):
    """The per-axis sample table K2 and K4 build in shared memory, for each
    RoI and each of the P*s samples of one axis (sample p*s + i at
    ``lo + bin * (p + (i + 0.5) / s)``): its two clamped corners ``v0``,
    ``v1`` (int64), its two weights ``h = 1 - l`` and ``l``, and its inside
    flag (the coordinate in [-1, extent]). ``lo``, ``bin_size`` (N,)
    float32, ``extent`` (N,) int; each result (N, P*s). A sample of the
    grid is inside when both of its axes' samples are."""
    p, s = out_size, sampling_ratio
    sub = (torch.arange(s, dtype=torch.float32, device=lo.device) + 0.5) / s
    grid = (torch.arange(p, dtype=torch.float32, device=lo.device)[:, None] +
            sub[None, :]).reshape(-1)
    v = lo[:, None] + bin_size[:, None] * grid[None, :]
    ef = extent.float()[:, None]
    inside = (v >= -1.0) & (v <= ef)
    vc = torch.minimum(v.clamp(min=0.0), ef - 1)
    v0 = torch.floor(vc)
    l = vc - v0
    v0i = v0.long()
    v1i = torch.minimum(v0i + 1, extent.long()[:, None] - 1)
    return v0i, v1i, 1.0 - l, l, inside


def roi_align_fwd_plain(flat: torch.Tensor, rois: torch.Tensor,
                        base: torch.Tensor, hs: torch.Tensor,
                        ws: torch.Tensor, scales: torch.Tensor,
                        out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch form of K2: the same samples as a gather.

    ``flat`` (rows, C); ``rois`` (N, 4); ``base`` (N,) int64 first row of
    each RoI's plane; ``hs``/``ws`` (N,) int32 plane extent; ``scales`` (N,)
    float32 coordinate scale. Returns (N, P, P, C) in the type of ``flat``,
    computed in fp32 and rounded once."""
    n, c = rois.shape[0], flat.shape[1]
    p, s = out_size, sampling_ratio
    (y1, bin_h), (x1, bin_w) = _roi_axes(rois, scales, p)
    y0i, y1i, hy, ly, in_y = roi_axis_samples(y1, bin_h, hs, p, s)
    x0i, x1i, hx, lx, in_x = roi_axis_samples(x1, bin_w, ws, p, s)
    inside = (in_y[:, :, None] & in_x[:, None, :]).float()
    e_y = (lambda t: t[:, :, None])
    e_x = (lambda t: t[:, None, :])
    wl = ws.long()[:, None, None]
    b = base.long()[:, None, None]

    def take(yi, xi):
        return flat[(b + e_y(yi) * wl + e_x(xi)).reshape(-1)].float()

    v = (take(y0i, x0i) * (e_y(hy) * e_x(hx) * inside).reshape(-1, 1) +
         take(y0i, x1i) * (e_y(hy) * e_x(lx) * inside).reshape(-1, 1) +
         take(y1i, x0i) * (e_y(ly) * e_x(hx) * inside).reshape(-1, 1) +
         take(y1i, x1i) * (e_y(ly) * e_x(lx) * inside).reshape(-1, 1))
    return v.reshape(n, p, s, p, s, c).mean(dim=(2, 4)).to(flat.dtype)


# Launch configuration of K2 and K4. The constants mirror the kernels'
# (csrc/roi_align.cu, csrc/roi_align_bwd.cu), which check what they are
# given and refuse a configuration they cannot run.
ROI_ENTRY_BYTES = 16         # shared bytes per axis sample
ROI_BLOCK_ELEMS = 8192       # K2: crop elements a block covers, about
K4_BAND = 4                  # K4: output rows a block covers


def roi_align_launch_config(kernel: str, n: int, p: int, s: int, c: int,
                            aligned: bool = True,
                            elem_bytes: int = 4) -> dict:
    """How K2 (``kernel='k2'``) or K4 (``'k4'``) is launched on ``n`` RoIs
    of P x P bins, ``s`` x ``s`` samples a bin, C channels: one block per
    (RoI, band of ``band_rows`` output rows; ``n_bands`` bands), about
    ``ROI_BLOCK_ELEMS`` crop elements a block in K2 and ``K4_BAND`` rows in
    K4 (the best of both at the training crops, on the card), narrowed
    until there are ``MIN_BLOCKS`` blocks where it can; the x table of the
    RoI's P*s samples and the y table of the band's ``band_rows * s`` in
    ``smem_bytes`` of shared memory; ``2 ** lanes_log2`` threads per entry
    of the lane walk (an output column in K2, a feature column in K4), each
    ``vec`` channels at a time where C comes in such runs and the bases are
    16-byte ``aligned``, else 1: in K2 the 16 bytes of one access of the
    features, 4 fp32 or 8 bf16 elements (``elem_bytes`` 4 or 2), in K4 4
    in either type (its lanes end in 16-byte fp32 reductions into
    ``d_flat``)."""
    if kernel not in ('k2', 'k4'):
        raise ValueError(f'roi_align_launch_config: kernel k2 or k4, got '
                         f'{kernel}')
    wide = VEC_BYTES // elem_bytes if kernel == 'k2' else REDUCE_VEC
    vec = wide if aligned and c % wide == 0 else 1
    lanes_log2 = 0
    while (1 << lanes_log2) < min(32, c // vec):
        lanes_log2 += 1
    if kernel == 'k4':
        band = min(p, K4_BAND)
    else:
        band = max(1, min(p, ROI_BLOCK_ELEMS // max(1, p * c)))
    while band > 1 and n * -(-p // band) < MIN_BLOCKS:
        band = (band + 1) // 2
    return dict(band_rows=band, n_bands=-(-p // band), vec=vec,
                lanes_log2=lanes_log2,
                smem_bytes=(p + band) * s * ROI_ENTRY_BYTES)


def _check_crop(name, flat, rois, base, hs, ws, scales):
    n, dev = rois.shape[0], flat.device
    if dev.type != 'cuda':
        raise ValueError(f'{name}: features must be on a CUDA device, got '
                         f'{dev}')
    if flat.dtype not in DTYPES:
        raise TypeError(f'{name}: features must be float32 or bfloat16, got '
                        f'{flat.dtype}')
    for arg, t, dt, shape in (
            ('flat', flat, flat.dtype, None),
            ('rois', rois, torch.float32, (n, 4)),
            ('base', base, torch.int64, (n,)),
            ('hs', hs, torch.int32, (n,)),
            ('ws', ws, torch.int32, (n,)),
            ('scales', scales, torch.float32, (n,))):
        if t.device != dev:
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


_FNS = {}   # the kernels' C functions, their argument types set


def _launch(kernel: str, dtype: torch.dtype, tensors, n: int, c: int,
            p: int, s: int, rows: int, cfg: dict, stream: int) -> None:
    """Launch the ``dtype`` instance of K2 (``kernel='k2'``: features, RoI
    arguments, output) or K4 (``'k4'``: d_out, RoI arguments, d_flat) with
    the launch configuration ``cfg`` (:func:`roi_align_launch_config`)."""
    name = 'roi_align_fwd' if kernel == 'k2' else 'roi_align_bwd'
    fn = _FNS.get((kernel, dtype))
    if fn is None:
        lib = 'roi_align' if kernel == 'k2' else 'roi_align_bwd'
        fn = getattr(_build.load(lib), f'{name}_{DTYPES[dtype]}')
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 +
                       [ctypes.c_longlong] + [ctypes.c_int] * 4 +
                       [ctypes.c_void_p])
        _FNS[kernel, dtype] = fn
    rc = fn(*[t.data_ptr() for t in tensors], n, c, p, s, rows,
            cfg['band_rows'], cfg['vec'], cfg['lanes_log2'],
            cfg['smem_bytes'], stream)
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{rc}')


def roi_align_fwd(flat: torch.Tensor, rois: torch.Tensor, base: torch.Tensor,
                  hs: torch.Tensor, ws: torch.Tensor, scales: torch.Tensor,
                  out_size: int, sampling_ratio: int) -> torch.Tensor:
    """K2 wrapper: the CUDA kernel's instance of the features' type (fp32
    or bf16) for CUDA tensors, the plain version for CPU tensors. Arguments
    as :func:`roi_align_fwd_plain`. Carries no gradient:
    :func:`roi_align_flat` is the differentiable entry. ``launches``
    counts each instance's launches (``deform_conv._count``)."""
    _refuse_grad('roi_align_fwd', flat)
    if flat.device.type == 'cpu':
        return roi_align_fwd_plain(flat, rois, base, hs, ws, scales,
                                   out_size, sampling_ratio)
    _check_crop('roi_align_fwd', flat, rois, base, hs, ws, scales)
    n, c = rois.shape[0], flat.shape[1]
    out = torch.empty((n, out_size, out_size, c), dtype=flat.dtype,
                      device=flat.device)
    if out.numel() == 0:
        return out
    cfg = roi_align_launch_config('k2', n, out_size, sampling_ratio, c,
                                  aligned=_aligned(flat, out),
                                  elem_bytes=flat.element_size())
    _launch('k2', flat.dtype, (flat, rois, base, hs, ws, scales, out), n, c,
            out_size, sampling_ratio, flat.shape[0], cfg,
            torch.cuda.current_stream(flat.device).cuda_stream)
    _count(roi_align_fwd, flat.dtype)
    return out


roi_align_fwd.launches = {'': 0, BF16: 0}


def roi_align_bwd_plain(d_out: torch.Tensor, rows: int, rois: torch.Tensor,
                        base: torch.Tensor, hs: torch.Tensor,
                        ws: torch.Tensor, scales: torch.Tensor,
                        out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Plain PyTorch form of K4: the gradient (rows, C) of the flat
    features from ``d_out`` (N, P, P, C), as autograd of
    :func:`roi_align_fwd_plain` (the crop is linear in the features), in
    fp32 from a ``d_out`` of either type: the kernel's sum, which the
    caller rounds for a bf16 crop (:class:`_RoIAlignFlat`)."""
    flat = torch.zeros(rows, d_out.shape[-1], device=d_out.device,
                       requires_grad=True)
    with torch.enable_grad():
        out = roi_align_fwd_plain(flat, rois, base, hs, ws, scales, out_size,
                                  sampling_ratio)
    return torch.autograd.grad(out, flat, d_out.float())[0]


def roi_align_bwd(d_out: torch.Tensor, rows: int, rois: torch.Tensor,
                  base: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                  scales: torch.Tensor, out_size: int,
                  sampling_ratio: int) -> torch.Tensor:
    """K4 wrapper: the CUDA kernel's instance of the type of ``d_out``
    (fp32 or bf16) for CUDA tensors, the plain version for CPU tensors.
    Arguments as :func:`roi_align_bwd_plain`. The result is summed with
    fp32 atomics into the fp32 buffer it returns, so its last bits vary
    from run to run. ``launches`` counts each instance's launches
    (``deform_conv._count``)."""
    if d_out.device.type == 'cpu':
        return roi_align_bwd_plain(d_out, rows, rois, base, hs, ws, scales,
                                   out_size, sampling_ratio)
    n, c = rois.shape[0], d_out.shape[-1]
    d_flat = torch.zeros((rows, c), dtype=torch.float32, device=d_out.device)
    _check_crop('roi_align_bwd', d_flat, rois, base, hs, ws, scales)
    if (d_out.dtype not in DTYPES or not d_out.is_contiguous() or
            tuple(d_out.shape) != (n, out_size, out_size, c)):
        raise ValueError(f'roi_align_bwd: d_out must be a contiguous float32 '
                         f'or bfloat16 {(n, out_size, out_size, c)} tensor, '
                         f'got {tuple(d_out.shape)} {d_out.dtype}')
    if d_out.numel() == 0:
        return d_flat
    cfg = roi_align_launch_config('k4', n, out_size, sampling_ratio, c,
                                  aligned=_aligned(d_out, d_flat),
                                  elem_bytes=d_out.element_size())
    _launch('k4', d_out.dtype, (d_out, rois, base, hs, ws, scales, d_flat),
            n, c, out_size, sampling_ratio, rows, cfg,
            torch.cuda.current_stream(d_out.device).cuda_stream)
    _count(roi_align_bwd, d_out.dtype)
    return d_flat


roi_align_bwd.launches = {'': 0, BF16: 0}


class _RoIAlignFlat(torch.autograd.Function):
    """K2 forward, K4 backward; the gradient of the features only, in their
    type: K4 reads the crop gradient in it, sums in fp32, and the sum is
    rounded once."""

    @staticmethod
    def forward(ctx, flat, rois, base, hs, ws, scales, out_size,
                sampling_ratio):
        ctx.save_for_backward(rois, base, hs, ws, scales)
        ctx.conf = (flat.shape[0], out_size, sampling_ratio, flat.dtype)
        return roi_align_fwd(flat, rois, base, hs, ws, scales, out_size,
                             sampling_ratio)

    @staticmethod
    def backward(ctx, d_out):
        rows, p, s, dtype = ctx.conf
        d_flat = roi_align_bwd(d_out.contiguous().to(dtype), rows,
                               *ctx.saved_tensors, p, s)
        return d_flat.to(dtype), None, None, None, None, None, None, None


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
    """Concatenate NHWC planes into one (rows, C) buffer of their type;
    returns it with each level's first row."""
    c = features[0].shape[-1]
    flats = [f.reshape(-1, c) for f in features]
    offsets = [0]
    for f in flats[:-1]:
        offsets.append(offsets[-1] + f.shape[0])
    flat = flats[0] if len(flats) == 1 else torch.cat(flats, 0)
    return flat.contiguous(), offsets


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


def multilevel_crop_args(features: Sequence[torch.Tensor],
                         rois: torch.Tensor, roi_batch: torch.Tensor,
                         featmap_strides: Tuple[int, ...],
                         finest_scale: int = 56):
    """The flat-crop arguments of the FPN-routed RoIAlign over NHWC
    ``features``: (flat, RoIs, base, hs, ws, scales), each RoI on the
    plane of its level (:func:`map_roi_levels`)."""
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
    return flat, rois, base, h_per, w_per, scales


def multilevel_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                         roi_batch: torch.Tensor, out_size: int,
                         featmap_strides: Tuple[int, ...],
                         sampling_ratio: int = 2,
                         finest_scale: int = 56) -> torch.Tensor:
    """FPN-routed RoIAlign over NHWC levels (B, Hl, Wl, C), one kernel
    launch for the whole pyramid -> (N, P, P, C)."""
    return roi_align_flat(*multilevel_crop_args(
        features, rois, roi_batch, featmap_strides, finest_scale), out_size,
        sampling_ratio)


def generic_crop_args(features: Sequence[torch.Tensor], rois: torch.Tensor,
                      roi_batch: torch.Tensor,
                      featmap_strides: Tuple[int, ...]):
    """The flat-crop arguments of GRoIE's extract over NHWC ``features``:
    (flat, RoIs, base, hs, ws, scales) of L*N rows, level after level, each
    RoI repeated with each level's plane base and ``1/stride``."""
    num_levels = len(features)
    assert num_levels == len(featmap_strides)
    n, dev = rois.shape[0], features[0].device
    flat, offsets = _flat_planes(features)
    hs = torch.tensor([f.shape[1] for f in features], dtype=torch.int32,
                      device=dev).repeat_interleave(n)
    ws = torch.tensor([f.shape[2] for f in features], dtype=torch.int32,
                      device=dev).repeat_interleave(n)
    base = (torch.tensor(offsets, dtype=torch.int64,
                         device=dev).repeat_interleave(n) +
            roi_batch.long().repeat(num_levels) * hs.long() * ws.long())
    scales = (1.0 / torch.tensor(featmap_strides, dtype=torch.float32,
                                 device=dev)).repeat_interleave(n)
    return flat, rois.repeat(num_levels, 1), base, hs, ws, scales


def generic_roi_align(features: Sequence[torch.Tensor], rois: torch.Tensor,
                      roi_batch: torch.Tensor, out_size: int,
                      featmap_strides: Tuple[int, ...],
                      sampling_ratio: int = 2,
                      aggregation: str = 'sum') -> torch.Tensor:
    """GRoIE's extract (mmdet ``GenericRoIExtractor``): every RoI pooled
    from every NHWC level at its ``1/stride``, no routing, then the L crops
    summed (``'sum'``, (N, P, P, C)) or put side by side level after level
    on the channels (``'concat'``, (N, P, P, L*C)). One kernel launch takes
    all L*N crops (:func:`generic_crop_args`); the gradient is one launch
    too."""
    if aggregation not in ('sum', 'concat'):
        raise NotImplementedError(f'GenericRoIExtractor aggregation '
                                  f'{aggregation!r}')
    n = rois.shape[0]
    crops = roi_align_flat(*generic_crop_args(features, rois, roi_batch,
                                              featmap_strides),
                           out_size, sampling_ratio)
    crops = crops.reshape(len(features), n, *crops.shape[1:])
    if aggregation == 'sum':
        return crops.sum(0)
    return crops.permute(1, 2, 3, 0, 4).reshape(n, out_size, out_size, -1)


def simple_roi_align(features: torch.Tensor, rois: torch.Tensor,
                     roi_batch: torch.Tensor, out_size: int,
                     spatial_scale: float,
                     sampling_ratio: int = 1) -> torch.Tensor:
    """Aligned single-level RoIAlign of the semantic crops (mmcv
    SimpleRoIAlign), one sample per bin by default."""
    return roi_align(features, rois, roi_batch, out_size, spatial_scale,
                     sampling_ratio=sampling_ratio)
