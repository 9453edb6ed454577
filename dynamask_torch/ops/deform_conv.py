"""Bounded-window deformable conv (DCNv1), forward and backward.

Port of the windowed DCN of the JAX package: the semantics of
``dynamask_tpu/ops/deform_conv.py:_deform_conv2d_windowed_ref`` (:82-175)
and ``dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm``
(:387-518), which the SFM ``fuse_conv_1`` of every DynaMask stage runs, and
of their analytic VJPs ``_windowed_cvjp_bwd`` (``deform_conv.py:209-343``)
and ``_rowmm_ad_bwd`` (``deform_conv_pallas.py:651-741``).

For output pixel (y, x), deform group g and tap t = (i, j) the displacement
is ``rel = (i*dil - pad, j*dil - pad) + offset``. The sample is zero when the
UNCLIPPED absolute position falls outside ``(-1, extent)`` on either axis;
otherwise ``rel`` is clipped to ``±window`` and the sample is bilinear on the
zero-padded plane. Offset channels are laid out ``(g, kh, kw, [dy, dx])``.

:func:`deform_conv2d` (and :func:`deform_conv2d_nhwc`) is a
``torch.autograd.Function``:

* forward: :func:`deform_im2col_windowed` writes the sampled column tensor
  ``(n, H, W, g, k*k, C/g)`` (kernel K1, ``csrc/deform_im2col.cu``), then one
  ``torch.matmul`` contracts ``(tap, channel) -> C_out``, as the JAX package
  leaves its einsum outside the Pallas kernel. Only ``x``, the offsets and
  the weight are saved, not the column tensor;
* backward: K1 runs again to recompute the columns (the JAX backward
  recomputes them too, ``deform_conv_pallas.py:676-678``), ``d_w`` and
  ``d_col`` are ``torch.matmul``, and :func:`deform_col2im_windowed`
  (kernel K3, ``csrc/deform_col2im.cu``) gives ``d_x`` and ``d_offset``.

The backward reproduces the JAX gradient rules, not autodiff of a
``floor``-based form: the tent derivative is ``-sign(z)`` on ``|z| < 1`` and
0 at ``z = 0`` (so an integer displacement, e.g. every offset at its zero
init, gets exactly zero offset gradient); the clip passes gradient only
where the unclipped displacement lies strictly inside ``(-window,
window)``; the inside masks are constants.

On a CPU tensor K1 and K3 run their plain PyTorch versions beside them.
Public functions keep the JAX layouts: NHWC features and HWIO weights.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper returns a tensor with no ``grad_fn``: refuse inputs
    that would need one, instead of cutting the graph without a word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f'{name} carries no gradient; call the autograd '
                           'function over it (deform_conv2d / roi_align)')


def _geometry(offsets: torch.Tensor, h: int, w: int, k: int, padding: int,
              dilation: int, g: int, window: int):
    """Per (n, y, x, g, tap): the unclipped displacements, the inside mask,
    the clipped displacements, their floors and the four tent weights."""
    n = offsets.shape[0]
    dev = offsets.device
    off = offsets.reshape(n, h, w, g, k * k, 2).float()
    base = torch.arange(k, dtype=torch.float32, device=dev) * dilation - \
        padding
    rel_y0 = base.repeat_interleave(k) + off[..., 0]    # i-major tap order
    rel_x0 = base.repeat(k) + off[..., 1]
    iy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1, 1, 1)
    ix = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w, 1, 1)
    ins = ((iy + rel_y0 > -1.0) & (iy + rel_y0 < h) &
           (ix + rel_x0 > -1.0) & (ix + rel_x0 < w)).float()
    rel_y = rel_y0.clamp(-window, window)
    rel_x = rel_x0.clamp(-window, window)
    fy, fx = torch.floor(rel_y), torch.floor(rel_x)
    wy = (1.0 - (rel_y - fy), 1.0 - ((fy + 1.0) - rel_y))
    wx = (1.0 - (rel_x - fx), 1.0 - ((fx + 1.0) - rel_x))
    return rel_y0, rel_x0, ins, rel_y, rel_x, fy, fx, wy, wx


def _corner_index(n, h, w, g, fy, fx, window):
    """Row of the (y0, x0) corner in the zero-padded (n*Hp*Wp*g) plane
    buffer of :func:`_padded`, and the row step of one plane row."""
    dev = fy.device
    pad = window + 1
    hp, wp = h + 2 * pad, w + 2 * pad
    iy = torch.arange(h, device=dev).view(1, h, 1, 1, 1)
    ix = torch.arange(w, device=dev).view(1, 1, w, 1, 1)
    row = torch.arange(n, device=dev).view(n, 1, 1, 1, 1) * hp + iy + pad + \
        fy.long()
    pix = row * wp + ix + pad + fx.long()
    gsel = torch.arange(g, device=dev).view(1, 1, 1, g, 1)
    return pix * g + gsel, wp * g


def _padded(x: torch.Tensor, window: int, g: int) -> torch.Tensor:
    """``x`` zero-padded by window + 1 (every clipped corner lands inside)
    as a (n*Hp*Wp*g, C/g) row buffer."""
    pad = window + 1
    c = x.shape[-1]
    return F.pad(x.float(), (0, 0, pad, pad, pad, pad)).reshape(-1, c // g)


def deform_im2col_windowed_plain(x: torch.Tensor, offsets: torch.Tensor,
                                 kernel_size: int = 3, padding: int = 1,
                                 dilation: int = 1, deform_groups: int = 1,
                                 window: int = 3) -> torch.Tensor:
    """Plain PyTorch form of K1: ``x`` (n, H, W, C), ``offsets``
    (n, H, W, 2*g*k*k) -> column tensor (n, H, W, g, k*k, C/g)."""
    n, h, w, _ = x.shape
    g = deform_groups
    _, _, ins, _, _, fy, fx, (wy0, wy1), (wx0, wx1) = _geometry(
        offsets, h, w, kernel_size, padding, dilation, g, window)
    idx, step = _corner_index(n, h, w, g, fy, fx, window)
    xg = _padded(x, window, g)
    v00, v01 = xg[idx], xg[idx + g]
    v10, v11 = xg[idx + step], xg[idx + step + g]
    e = (lambda t: t[..., None])
    out = ((v00 * e(wx0) + v01 * e(wx1)) * e(wy0) +
           (v10 * e(wx0) + v11 * e(wx1)) * e(wy1))
    return out * e(ins)


def deform_col2im_windowed_plain(x: torch.Tensor, offsets: torch.Tensor,
                                 d_col: torch.Tensor, kernel_size: int = 3,
                                 padding: int = 1, dilation: int = 1,
                                 deform_groups: int = 1, window: int = 3):
    """Plain PyTorch form of K3, the VJP of K1: ``d_col``
    (n, H, W, g, k*k, C/g) -> (``d_x`` (n, H, W, C), ``d_offset``
    (n, H, W, 2*g*k*k)), written out by hand after ``_windowed_cvjp_bwd``
    (``dynamask_tpu/ops/deform_conv.py:239-326``)."""
    n, h, w, c = x.shape
    g, d = deform_groups, window
    rel_y0, rel_x0, ins, rel_y, rel_x, fy, fx, (wy0, wy1), (wx0, wx1) = \
        _geometry(offsets, h, w, kernel_size, padding, dilation, g, d)
    idx, step = _corner_index(n, h, w, g, fy, fx, d)
    xg = _padded(x, d, g)
    v00, v01 = xg[idx], xg[idx + g]
    v10, v11 = xg[idx + step], xg[idx + step + g]
    e = (lambda t: t[..., None])
    dc = d_col.float() * e(ins)

    # d_x: scatter each sample's gradient into its four corners; corners
    # off the plane land in the zero pad, which is cut away
    d_xg = torch.zeros_like(xg)
    for off_idx, wgt in ((idx, wy0 * wx0), (idx + g, wy0 * wx1),
                         (idx + step, wy1 * wx0),
                         (idx + step + g, wy1 * wx1)):
        d_xg.index_add_(0, off_idx.reshape(-1),
                        (dc * e(wgt)).reshape(-1, c // g))
    pad = d + 1
    d_x = d_xg.reshape(n, h + 2 * pad, w + 2 * pad, c)[
        :, pad:pad + h, pad:pad + w]

    # d_offset: the tent derivative (+1 towards the far corner, 0 where the
    # clipped displacement is an integer), through the clip only strictly
    # inside the window
    s_y = (dc * (e(wx0) * (v10 - v00) + e(wx1) * (v11 - v01))).sum(-1)
    s_x = (dc * (e(wy0) * (v01 - v00) + e(wy1) * (v11 - v10))).sum(-1)
    d_ry = torch.where((rel_y > fy) & (rel_y0.abs() < d), s_y, 0.0)
    d_rx = torch.where((rel_x > fx) & (rel_x0.abs() < d), s_x, 0.0)
    d_off = torch.stack([d_ry, d_rx], -1).reshape(offsets.shape)
    return d_x.contiguous(), d_off


def _check_nhwc(name, x, offsets, k, g):
    n, h, w, c = x.shape
    expect = (n, h, w, 2 * g * k * k)
    if x.device.type != 'cuda' or offsets.device != x.device:
        raise ValueError(f'{name}: x and offsets must be on one CUDA device, '
                         f'got {x.device}, {offsets.device}')
    if x.dtype != torch.float32 or offsets.dtype != torch.float32:
        raise TypeError(f'{name}: float32 only, got {x.dtype}, '
                        f'{offsets.dtype}')
    if tuple(offsets.shape) != expect or c % g:
        raise ValueError(f'{name}: x {tuple(x.shape)} / offsets '
                         f'{tuple(offsets.shape)}, expected offsets {expect} '
                         f'and C divisible by {g}')
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError(f'{name}: x and offsets must be contiguous NHWC')


def deform_im2col_windowed(x: torch.Tensor, offsets: torch.Tensor,
                           kernel_size: int = 3, padding: int = 1,
                           dilation: int = 1, deform_groups: int = 1,
                           window: int = 3) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`deform_im2col_windowed_plain`. Carries
    no gradient: :func:`deform_conv2d` is the differentiable entry."""
    _refuse_grad('deform_im2col_windowed', x, offsets)
    if x.device.type == 'cpu':
        return deform_im2col_windowed_plain(x, offsets, kernel_size, padding,
                                            dilation, deform_groups, window)
    _check_nhwc('deform_im2col_windowed', x, offsets, kernel_size,
                deform_groups)
    n, h, w, c = x.shape
    k, g = kernel_size, deform_groups
    col = torch.empty((n, h, w, g, k * k, c // g), dtype=torch.float32,
                      device=x.device)
    if col.numel() == 0:
        return col
    fn = _build.load('deform_im2col').deform_im2col_windowed_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), col.data_ptr(), n, h, w, c, g,
            k, padding, dilation, window, stream)
    if rc != 0:
        raise RuntimeError('deform_im2col_windowed: kernel launch failed '
                           f'with CUDA error {rc}')
    deform_im2col_windowed.launches += 1
    return col


deform_im2col_windowed.launches = 0


def deform_col2im_windowed(x: torch.Tensor, offsets: torch.Tensor,
                           d_col: torch.Tensor, kernel_size: int = 3,
                           padding: int = 1, dilation: int = 1,
                           deform_groups: int = 1, window: int = 3):
    """K3 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`deform_col2im_windowed_plain`; returns
    ``(d_x, d_offset)``. ``d_x`` is summed with fp32 atomics, so its last
    bits vary from run to run."""
    _refuse_grad('deform_col2im_windowed', x, offsets, d_col)
    if x.device.type == 'cpu':
        return deform_col2im_windowed_plain(x, offsets, d_col, kernel_size,
                                            padding, dilation, deform_groups,
                                            window)
    _check_nhwc('deform_col2im_windowed', x, offsets, kernel_size,
                deform_groups)
    n, h, w, c = x.shape
    k, g = kernel_size, deform_groups
    expect = (n, h, w, g, k * k, c // g)
    if (d_col.device != x.device or d_col.dtype != torch.float32 or
            tuple(d_col.shape) != expect or not d_col.is_contiguous()):
        raise ValueError(f'deform_col2im_windowed: d_col must be a '
                         f'contiguous float32 {expect} tensor on {x.device}, '
                         f'got {tuple(d_col.shape)} {d_col.dtype} on '
                         f'{d_col.device}')
    d_x = torch.zeros_like(x)
    d_off = torch.empty_like(offsets)
    if d_col.numel() == 0:
        return d_x, d_off.zero_()
    fn = _build.load('deform_col2im').deform_col2im_windowed_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), d_col.data_ptr(),
            d_x.data_ptr(), d_off.data_ptr(), n, h, w, c, g, k, padding,
            dilation, window, stream)
    if rc != 0:
        raise RuntimeError('deform_col2im_windowed: kernel launch failed '
                           f'with CUDA error {rc}')
    deform_col2im_windowed.launches += 1
    return d_x, d_off


deform_col2im_windowed.launches = 0


def im2col_weight(weight_oihw: torch.Tensor,
                  deform_groups: int) -> torch.Tensor:
    """OIHW kernel (C_out, C, k, k) -> (g*k*k*C/g, C_out), the row order of
    the column tensor."""
    c_out, c, kh, kw = weight_oihw.shape
    g = deform_groups
    w = weight_oihw.reshape(c_out, g, c // g, kh, kw)
    return w.permute(1, 3, 4, 2, 0).reshape(g * kh * kw * (c // g), c_out)


class _WindowedDeformConv(torch.autograd.Function):
    """K1 + GEMM forward; recompute (K1), two GEMMs and K3 backward."""

    @staticmethod
    def forward(ctx, x, offsets, w2, kernel_size, padding, dilation,
                deform_groups, window):
        conf = (kernel_size, padding, dilation, deform_groups, window)
        n, h, w, _ = x.shape
        col = deform_im2col_windowed(x, offsets, *conf)
        out = torch.matmul(col.reshape(n * h * w, -1), w2)
        ctx.save_for_backward(x, offsets, w2)
        ctx.conf = conf
        return out.reshape(n, h, w, -1)

    @staticmethod
    def backward(ctx, d_out):
        x, offsets, w2 = ctx.saved_tensors
        k, _, _, g, _ = ctx.conf
        n, h, w, c = x.shape
        d_out = d_out.reshape(n * h * w, -1).float()
        d_w2 = None
        if ctx.needs_input_grad[2]:
            col = deform_im2col_windowed(x, offsets, *ctx.conf)
            d_w2 = torch.matmul(col.reshape(n * h * w, -1).t(), d_out)
            del col
        d_x = d_off = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_col = torch.matmul(d_out, w2.t()).reshape(n, h, w, g, k * k,
                                                        c // g)
            d_x, d_off = deform_col2im_windowed(x, offsets, d_col, *ctx.conf)
        return d_x, d_off, d_w2, None, None, None, None, None


def deform_conv2d_nhwc(x: torch.Tensor, offsets: torch.Tensor,
                       weight_oihw: torch.Tensor, kernel_size: int = 3,
                       padding: int = 1, dilation: int = 1,
                       deform_groups: int = 1,
                       window: int = 3) -> torch.Tensor:
    """Windowed DCN of NHWC ``x`` with an OIHW (torch-layout) kernel ->
    (n, H, W, C_out) contiguous NHWC; differentiable in all three."""
    return _WindowedDeformConv.apply(
        x.contiguous().float(), offsets.contiguous().float(),
        im2col_weight(weight_oihw, deform_groups), kernel_size, padding,
        dilation, deform_groups, window)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weights: torch.Tensor, kernel_size: int = 3,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1, window: int = 3) -> torch.Tensor:
    """The JAX signature: ``x`` (N, H, W, C), ``offsets``
    (N, H, W, 2*g*k*k), HWIO ``weights`` (k, k, C, C_out) ->
    (N, H, W, C_out). Stride 1, bounded window only (the SFM case)."""
    if stride != 1 or window is None:
        raise NotImplementedError('deform_conv2d: the port has the stride-1 '
                                  'bounded-window form only')
    return deform_conv2d_nhwc(x, offsets, weights.permute(3, 2, 0, 1),
                              kernel_size, padding, dilation, deform_groups,
                              window)
