"""Bounded-window deformable conv (DCNv1), forward.

Port of the windowed DCN of the JAX package: the semantics of
``dynamask_tpu/ops/deform_conv.py:_deform_conv2d_windowed_ref`` (:82-175)
and ``dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_rowmm``
(:387-518), which the SFM ``fuse_conv_1`` of every DynaMask stage runs.

For output pixel (y, x), deform group g and tap t = (i, j) the displacement
is ``rel = (i*dil - pad, j*dil - pad) + offset``. The sample is zero when the
UNCLIPPED absolute position falls outside ``(-1, extent)`` on either axis;
otherwise ``rel`` is clipped to ``±window`` and the sample is bilinear on the
zero-padded plane. Offset channels are laid out ``(g, kh, kw, [dy, dx])``.

:func:`deform_im2col_windowed` writes the sampled column tensor
``(n, H, W, g, k*k, C/g)``: on a CUDA tensor through the hand-written kernel
K1 (``csrc/deform_im2col.cu``), on a CPU tensor through the plain PyTorch
version beside it. The ``(tap, channel) -> C_out`` contraction is one
``torch.matmul`` outside the kernel, as the JAX package leaves its einsum
outside the Pallas kernel (``deform_conv_pallas.py:513-518``). Public
functions keep the JAX layouts: NHWC features and HWIO weights.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def deform_im2col_windowed_plain(x: torch.Tensor, offsets: torch.Tensor,
                                 kernel_size: int = 3, padding: int = 1,
                                 dilation: int = 1, deform_groups: int = 1,
                                 window: int = 3) -> torch.Tensor:
    """Plain PyTorch form of K1: ``x`` (n, H, W, C), ``offsets``
    (n, H, W, 2*g*k*k) -> column tensor (n, H, W, g, k*k, C/g)."""
    n, h, w, c = x.shape
    k, g, d = kernel_size, deform_groups, window
    cg = c // g
    taps = k * k
    dev = x.device
    off = offsets.reshape(n, h, w, g, taps, 2).float()
    base = torch.arange(k, dtype=torch.float32, device=dev) * dilation - \
        padding
    tap_dy = base.repeat_interleave(k)            # i-major tap order
    tap_dx = base.repeat(k)
    rel_y = tap_dy + off[..., 0]                  # (n, H, W, g, T)
    rel_x = tap_dx + off[..., 1]
    iy = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1, 1, 1)
    ix = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w, 1, 1)
    ins = ((iy + rel_y > -1.0) & (iy + rel_y < h) &
           (ix + rel_x > -1.0) & (ix + rel_x < w)).float()
    rel_y = rel_y.clamp(-d, d)
    rel_x = rel_x.clamp(-d, d)
    fy, fx = torch.floor(rel_y), torch.floor(rel_x)
    wy0, wy1 = 1.0 - (rel_y - fy), 1.0 - ((fy + 1.0) - rel_y)
    wx0, wx1 = 1.0 - (rel_x - fx), 1.0 - ((fx + 1.0) - rel_x)

    # zero-pad by window + 1: every clipped corner lands inside the pad
    pad = d + 1
    hp, wp = h + 2 * pad, w + 2 * pad
    xg = F.pad(x.float(), (0, 0, pad, pad, pad, pad)).reshape(n * hp * wp,
                                                              g, cg)
    row = (torch.arange(n, device=dev).view(n, 1, 1, 1, 1) * hp +
           iy.long() + pad + fy.long())
    col = ix.long() + pad + fx.long()
    idx00 = row * wp + col
    gsel = torch.arange(g, device=dev).view(1, 1, 1, g, 1)

    def take(idx):
        return xg[idx, gsel]                       # (n, H, W, g, T, cg)

    v00, v01 = take(idx00), take(idx00 + 1)
    v10, v11 = take(idx00 + wp), take(idx00 + wp + 1)
    e = (lambda t: t[..., None])
    out = ((v00 * e(wx0) + v01 * e(wx1)) * e(wy0) +
           (v10 * e(wx0) + v11 * e(wx1)) * e(wy1))
    return out * e(ins)


def deform_im2col_windowed(x: torch.Tensor, offsets: torch.Tensor,
                           kernel_size: int = 3, padding: int = 1,
                           dilation: int = 1, deform_groups: int = 1,
                           window: int = 3) -> torch.Tensor:
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments as :func:`deform_im2col_windowed_plain`."""
    if x.device.type == 'cpu':
        return deform_im2col_windowed_plain(x, offsets, kernel_size, padding,
                                            dilation, deform_groups, window)
    n, h, w, c = x.shape
    k, g = kernel_size, deform_groups
    expect = (n, h, w, 2 * g * k * k)
    if x.device.type != 'cuda' or offsets.device != x.device:
        raise ValueError('deform_im2col_windowed: x and offsets must be on '
                         f'one CUDA device, got {x.device}, {offsets.device}')
    if x.dtype != torch.float32 or offsets.dtype != torch.float32:
        raise TypeError('deform_im2col_windowed: float32 only, got '
                        f'{x.dtype}, {offsets.dtype}')
    if tuple(offsets.shape) != expect or c % g:
        raise ValueError(f'deform_im2col_windowed: x {tuple(x.shape)} / '
                         f'offsets {tuple(offsets.shape)}, expected offsets '
                         f'{expect} and C divisible by {g}')
    if not (x.is_contiguous() and offsets.is_contiguous()):
        raise ValueError('deform_im2col_windowed: x and offsets must be '
                         'contiguous NHWC')
    col = torch.empty((n, h, w, g, k * k, c // g), dtype=torch.float32,
                      device=x.device)
    if col.numel() == 0:
        return col
    lib = _build.load('deform_im2col')
    fn = lib.deform_im2col_windowed_f32
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


def im2col_weight(weight_oihw: torch.Tensor,
                  deform_groups: int) -> torch.Tensor:
    """OIHW kernel (C_out, C, k, k) -> (g*k*k*C/g, C_out), the row order of
    the column tensor."""
    c_out, c, kh, kw = weight_oihw.shape
    g = deform_groups
    w = weight_oihw.reshape(c_out, g, c // g, kh, kw)
    return w.permute(1, 3, 4, 2, 0).reshape(g * kh * kw * (c // g), c_out)


def deform_conv2d_nhwc(x: torch.Tensor, offsets: torch.Tensor,
                       weight_oihw: torch.Tensor, kernel_size: int = 3,
                       padding: int = 1, dilation: int = 1,
                       deform_groups: int = 1,
                       window: int = 3) -> torch.Tensor:
    """Windowed DCN of NHWC ``x`` with an OIHW (torch-layout) kernel ->
    (n, H, W, C_out) contiguous NHWC."""
    n, h, w, _ = x.shape
    col = deform_im2col_windowed(x, offsets, kernel_size, padding, dilation,
                                 deform_groups, window)
    out = torch.matmul(col.reshape(n * h * w, -1),
                       im2col_weight(weight_oihw, deform_groups))
    return out.reshape(n, h, w, -1)


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
    return deform_conv2d_nhwc(x.contiguous(), offsets.contiguous(),
                              weights.permute(3, 2, 0, 1), kernel_size,
                              padding, dilation, deform_groups, window)
