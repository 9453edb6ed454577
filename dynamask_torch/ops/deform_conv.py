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

Both kernels have an fp32 and a bf16 instance, chosen by the type of
``x``, with the offsets (and K3's ``d_col``) in that type too. The bf16
instances compute in fp32 and round each result once (K1's samples, K3's
``d_offset``); K3 sums ``d_x`` in fp32 and the wrapper rounds it to bf16 at
the end, as the JAX VJP works in fp32 and casts its results to the inputs'
types. A CUDA tensor of any other type is refused. On a CPU tensor K1 and K3
run their plain PyTorch versions beside them, which take both types and
compute in fp32 the same way. Public functions keep the JAX layouts: NHWC
features and HWIO weights.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
    (n, H, W, 2*g*k*k) -> column tensor (n, H, W, g, k*k, C/g) in the type
    of ``x``, each sample computed in fp32 and rounded once."""
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
    return (out * e(ins)).to(x.dtype)


def deform_col2im_windowed_plain(x: torch.Tensor, offsets: torch.Tensor,
                                 d_col: torch.Tensor, kernel_size: int = 3,
                                 padding: int = 1, dilation: int = 1,
                                 deform_groups: int = 1, window: int = 3):
    """Plain PyTorch form of K3, the VJP of K1: ``d_col``
    (n, H, W, g, k*k, C/g) -> (``d_x`` (n, H, W, C), ``d_offset``
    (n, H, W, 2*g*k*k)), written out by hand after ``_windowed_cvjp_bwd``
    (``dynamask_tpu/ops/deform_conv.py:239-326``). Computed in fp32 from
    inputs of either type; ``d_x`` is rounded to the type of ``x`` and
    ``d_offset`` to that of ``offsets``."""
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
    return d_x.to(x.dtype).contiguous(), d_off.to(offsets.dtype)


# Launch configuration of K1 and K3. The constants mirror the kernels'
# (csrc/deform_im2col.cu, csrc/deform_col2im.cu), which check what they are
# given and refuse a configuration they cannot run.
K1_ENTRY_BYTES, K3_ENTRY_BYTES = 36, 40     # shared bytes per table entry
TABLE_CAP = 1024             # geometry table entries per chunk
BLOCK_ELEMS = 32768          # column elements a block covers, about
MIN_BLOCKS = 2 * 132         # two blocks for each of the H100's SMs
VEC_BYTES = 16               # one lane's access: 4 fp32 or 8 bf16 elements
REDUCE_VEC = 4               # channels a lane of a kernel that reduces into
                             # fp32 (K3, K4): one 16-byte fp32 reduction
# the kernels' instances, by the type of x: the C symbol's suffix
DTYPES = {torch.float32: 'f32', torch.bfloat16: 'bf16'}


def dcn_launch_config(kernel: str, n: int, h: int, w: int, c: int, g: int,
                      k: int = 3, aligned: bool = True,
                      elem_bytes: int = 4) -> dict:
    """How K1 (``kernel='k1'``) or K3 (``'k3'``) is launched on an
    (n, h, w, c) input with ``g`` deform groups and a k x k kernel: one
    block per (RoI, group, band of ``band_rows`` output rows; ``n_bands``
    bands), about ``BLOCK_ELEMS`` column elements a block, narrowed until
    there are ``MIN_BLOCKS`` blocks where it can; the geometry table
    ``table_entries`` (pixel, tap) entries a chunk, in ``smem_bytes`` of
    shared memory; ``2 ** lanes_log2`` threads per entry, each lane ``vec``
    channels at a time where the group's channels come in such runs and the
    bases are 16-byte ``aligned``, else 1: in K1 the 16 bytes of one access
    (4 fp32 or 8 bf16 elements, ``elem_bytes`` 4 or 2), in K3 4 in either
    type (``REDUCE_VEC``: its lanes end in 16-byte fp32 reductions into
    ``d_x``, which 8 channels a lane would split into half sectors)."""
    if kernel not in ('k1', 'k3'):
        raise ValueError(f'dcn_launch_config: kernel k1 or k3, got {kernel}')
    cg, taps = c // g, k * k
    wide = VEC_BYTES // elem_bytes if kernel == 'k1' else REDUCE_VEC
    vec = wide if aligned and cg % wide == 0 else 1
    lanes_log2 = 0
    while (1 << lanes_log2) < min(32, cg // vec):
        lanes_log2 += 1
    band = max(1, min(h, BLOCK_ELEMS // max(1, w * taps * cg)))
    while band > 1 and n * g * -(-h // band) < MIN_BLOCKS:
        band = (band + 1) // 2
    n_bands = -(-h // band)
    table = min(band * w * taps, TABLE_CAP)
    entry = K1_ENTRY_BYTES if kernel == 'k1' else K3_ENTRY_BYTES
    return dict(band_rows=band, n_bands=n_bands, table_entries=table,
                smem_bytes=table * entry, vec=vec, lanes_log2=lanes_log2)


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


BF16 = '_bf16'   # the suffix of a bf16 instance's name


def _count(wrapper, dtype: torch.dtype) -> None:
    """One launch of ``wrapper``'s instance of ``dtype``: ``launches`` is a
    dict keyed by the suffix of the instance's name, '' for fp32 and
    ``BF16`` for bf16."""
    wrapper.launches[BF16 if dtype == torch.bfloat16 else ''] += 1


def _check_nhwc(name, x, offsets, k, g):
    n, h, w, c = x.shape
    expect = (n, h, w, 2 * g * k * k)
    if x.device.type != 'cuda' or offsets.device != x.device:
        raise ValueError(f'{name}: x and offsets must be on one CUDA device, '
                         f'got {x.device}, {offsets.device}')
    if x.dtype not in DTYPES or offsets.dtype != x.dtype:
        raise TypeError(f'{name}: float32 or bfloat16 x with offsets of the '
                        f'same type, got {x.dtype}, {offsets.dtype}')
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
    """K1 wrapper: the CUDA kernel's instance of the type of ``x`` (fp32
    or bf16) for CUDA tensors, the plain version for CPU tensors. Arguments
    as :func:`deform_im2col_windowed_plain`. Carries no gradient:
    :func:`deform_conv2d` is the differentiable entry. ``launches`` counts
    each instance's launches (:func:`_count`)."""
    _refuse_grad('deform_im2col_windowed', x, offsets)
    if x.device.type == 'cpu':
        return deform_im2col_windowed_plain(x, offsets, kernel_size, padding,
                                            dilation, deform_groups, window)
    _check_nhwc('deform_im2col_windowed', x, offsets, kernel_size,
                deform_groups)
    n, h, w, c = x.shape
    k, g = kernel_size, deform_groups
    col = torch.empty((n, h, w, g, k * k, c // g), dtype=x.dtype,
                      device=x.device)
    if col.numel() == 0:
        return col
    cfg = dcn_launch_config('k1', n, h, w, c, g, k,
                            aligned=_aligned(x, col),
                            elem_bytes=x.element_size())
    fn = getattr(_build.load('deform_im2col'),
                 'deform_im2col_windowed_' + DTYPES[x.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), col.data_ptr(), n, h, w, c, g,
            k, padding, dilation, window, cfg['band_rows'],
            cfg['table_entries'], cfg['vec'], cfg['lanes_log2'],
            cfg['smem_bytes'], stream)
    if rc != 0:
        raise RuntimeError('deform_im2col_windowed: kernel launch failed '
                           f'with CUDA error {rc}')
    _count(deform_im2col_windowed, x.dtype)
    return col


deform_im2col_windowed.launches = {'': 0, BF16: 0}


def deform_col2im_windowed(x: torch.Tensor, offsets: torch.Tensor,
                           d_col: torch.Tensor, kernel_size: int = 3,
                           padding: int = 1, dilation: int = 1,
                           deform_groups: int = 1, window: int = 3):
    """K3 wrapper: the CUDA kernel's instance of the type of ``x`` (fp32
    or bf16; ``offsets`` and ``d_col`` in that type) for CUDA tensors, the
    plain version for CPU tensors. Arguments as
    :func:`deform_col2im_windowed_plain`; returns ``(d_x, d_offset)`` in the
    inputs' type. ``d_x`` is summed with fp32 atomics into an fp32 buffer
    (rounded to bf16 once at the end for a bf16 ``x``), so its last bits
    vary from run to run. ``launches`` counts each instance's launches
    (:func:`_count`)."""
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
    if (d_col.device != x.device or d_col.dtype != x.dtype or
            tuple(d_col.shape) != expect or not d_col.is_contiguous()):
        raise ValueError(f'deform_col2im_windowed: d_col must be a '
                         f'contiguous {x.dtype} {expect} tensor on '
                         f'{x.device}, got {tuple(d_col.shape)} '
                         f'{d_col.dtype} on {d_col.device}')
    d_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    d_off = torch.empty_like(offsets)
    if d_col.numel() == 0:
        return d_x.to(x.dtype), d_off.zero_()
    cfg = dcn_launch_config('k3', n, h, w, c, g, k,
                            aligned=_aligned(x, d_col, d_x),
                            elem_bytes=x.element_size())
    fn = getattr(_build.load('deform_col2im'),
                 'deform_col2im_windowed_' + DTYPES[x.dtype])
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), d_col.data_ptr(),
            d_x.data_ptr(), d_off.data_ptr(), n, h, w, c, g, k, padding,
            dilation, window, cfg['band_rows'], cfg['table_entries'],
            cfg['vec'], cfg['lanes_log2'], cfg['smem_bytes'], stream)
    if rc != 0:
        raise RuntimeError('deform_col2im_windowed: kernel launch failed '
                           f'with CUDA error {rc}')
    _count(deform_col2im_windowed, x.dtype)
    return d_x.to(x.dtype), d_off


deform_col2im_windowed.launches = {'': 0, BF16: 0}


def im2col_weight(weight_oihw: torch.Tensor,
                  deform_groups: int) -> torch.Tensor:
    """OIHW kernel (C_out, C, k, k) -> (g*k*k*C/g, C_out), the row order of
    the column tensor."""
    c_out, c, kh, kw = weight_oihw.shape
    g = deform_groups
    w = weight_oihw.reshape(c_out, g, c // g, kh, kw)
    return w.permute(1, 3, 4, 2, 0).reshape(g * kh * kw * (c // g), c_out)


class _WindowedDeformConv(torch.autograd.Function):
    """K1 + GEMM forward; recompute (K1), two GEMMs and K3 backward. ``x``,
    the offsets and the weight share one type, fp32 or bf16, and so do the
    output and each gradient (in bf16 the GEMMs take bf16 operands and sum
    in fp32, as the JAX einsum does with ``preferred_element_type``)."""

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
        d_out = d_out.reshape(n * h * w, -1).to(x.dtype)
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
    (n, H, W, C_out) contiguous NHWC; differentiable in all three. Computes
    in the type of ``x`` (fp32 or bf16): the offsets and the weight are
    taken in it."""
    return _WindowedDeformConv.apply(
        x.contiguous(), offsets.contiguous().to(x.dtype),
        im2col_weight(weight_oihw, deform_groups).to(x.dtype), kernel_size,
        padding, dilation, deform_groups, window)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                  weights: torch.Tensor, kernel_size: int = 3,
                  stride: int = 1, padding: int = 1, dilation: int = 1,
                  deform_groups: int = 1, window: Optional[int] = 3,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX signature: ``x`` (N, H, W, C), ``offsets``
    (N, Ho, Wo, 2*g*k*k), HWIO ``weights`` (k, k, C, C_out) ->
    (N, Ho, Wo, C_out). A ``window`` takes the bounded-window form through
    K1/K3 (stride 1, the SFM case); ``window=None`` the exact gather
    (:func:`deform_conv2d_exact`, any stride, DCNv2 with ``mask``)."""
    if window is None:
        return deform_conv2d_exact(x, offsets, weights, mask, kernel_size,
                                   stride, padding, dilation, deform_groups)
    if stride != 1 or mask is not None:
        raise NotImplementedError('deform_conv2d: the bounded-window form is '
                                  'stride 1 without a mask')
    return deform_conv2d_nhwc(x, offsets, weights.permute(3, 2, 0, 1),
                              kernel_size, padding, dilation, deform_groups,
                              window)


# -- the exact gather and the windowed DCNv2 (plain PyTorch) -----------------
#
# The DCNs of the backbones (ResNet's and RegNet's ``dcn``, FCOS's
# ``dcn_on_last_conv``) take two forms that the JAX package computes in XLA,
# never in Pallas: the exact gather ``deform_conv2d(window=None[, mask])``
# (``dynamask_tpu/ops/deform_conv.py:433-557``) and the windowed DCNv2
# ``modulated_deform_conv2d`` (``:569-653``). Here they are plain PyTorch on
# the device by design: no TPU kernel stands behind them, so none is ported.
# Each is a ``torch.autograd.Function`` that saves only its inputs: its
# backward recomputes a few taps at a time (JAX scans the taps under a
# checkpoint, so one tap's gather is live at a time through the backward)
# and writes out the gradient JAX's autodiff gives. At an integer sample
# position that gradient follows JAX's tie rules (ROADMAP.md queue 3,
# 3ak): ``d|z|/dz = 1`` at 0 and ``clip``'s tie splits 0.5, where torch's
# autodiff would take 0 and 1 and mmcv the right-hand slope.


def _jax_tent_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz ``clip(1 - |z|, 0)`` by JAX's autodiff rules: ``|z|'`` is 1 at
    z = 0, and ``clip``'s tie at 1 - |z| = 0 takes half."""
    u = 1.0 - z.abs()
    c = torch.where(u > 0, 1.0, torch.where(u == 0, 0.5, 0.0))
    return torch.where(z >= 0, -c, c)


def _jax_clip_grad(r: torch.Tensor, d: int) -> torch.Tensor:
    """d/dr ``clip(r, -d, d)`` by JAX's rules: half at either bound."""
    a = r.abs()
    return torch.where(a < d, 1.0, torch.where(a == d, 0.5, 0.0))


def _axis(base: torch.Tensor, off: torch.Tensor, extent: int,
          window: Optional[int]):
    """One axis of a run of taps' samples: ``base`` the displacement-free
    position (exact form) or the displacement's integer part (windowed),
    ``off`` the offsets. -> (low corner, its weight and the high corner's,
    inside flag, [(corner shift, gradient coefficient)], chain factor)."""
    if window is None:
        p = base + off
        inside = (p > -1.0) & (p < extent)
        f = torch.floor(p).clamp(0, extent - 1)
        grads = [(0, _jax_tent_grad(p - f)), (1, _jax_tent_grad(p - f - 1.0))]
        chain = None
        r = p
        lo = f
    else:
        grid, r0 = base
        r0 = r0 + off
        inside = (grid + r0 > -1.0) & (grid + r0 < extent)
        r = r0.clamp(-window, window)
        f = torch.floor(r)
        # JAX sums the tents over u in [-D, D+1]: at an integer r the corner
        # below r takes part in the gradient, but for u = -D - 1
        below = _jax_tent_grad(r - f + 1.0) * (f - 1.0 >= -window)
        grads = [(-1, below), (0, _jax_tent_grad(r - f)),
                 (1, _jax_tent_grad(r - f - 1.0))]
        chain = _jax_clip_grad(r0, window)
        lo = grid + f
    w0 = (1.0 - (r - f).abs()).clamp(min=0.0)
    w1 = (1.0 - (r - f - 1.0).abs()).clamp(min=0.0)
    return lo.long(), w0, w1, inside, grads, chain


class _Sampler:
    """The taps of a DCN over one (N, H, W, C) input: for a run of taps the
    bilinear sample positions of every (output pixel, tap, deform group),
    laid out (N, Ho, Wo, taps, g), gathered from a zero-padded row table
    (``pad`` rows and columns each side, so every corner a tap touches
    lands in it)."""

    def __init__(self, x, offsets, mask, k, stride, padding, dilation, g,
                 window):
        self.n, self.h, self.w, self.c = x.shape
        self.ho, self.wo = offsets.shape[1:3]
        self.k, self.g, self.window = k, g, window
        self.stride = stride
        self.pad = 1 if window is None else window + 1
        self.cd = torch.float64 if x.dtype == torch.float64 else \
            torch.float32
        p = self.pad
        self.hp, self.wp = self.h + 2 * p, self.w + 2 * p
        self.table = F.pad(x.to(self.cd), (0, 0, p, p, p, p)).reshape(
            -1, self.c // g)
        # tap-major: (N, Ho, Wo, taps, g[, 2])
        self.off = offsets.reshape(self.n, self.ho, self.wo, g, k * k,
                                   2).float().transpose(3, 4)
        self.mask = None if mask is None else mask.reshape(
            self.n, self.ho, self.wo, g, k * k).transpose(3, 4)
        dev = x.device
        tap = torch.arange(k * k, device=dev)
        self.dy = ((tap // k) * dilation - padding).float()
        self.dx = ((tap % k) * dilation - padding).float()
        self.oy = torch.arange(self.ho, dtype=torch.float32,
                               device=dev).view(1, -1, 1, 1, 1)
        self.ox = torch.arange(self.wo, dtype=torch.float32,
                               device=dev).view(1, 1, -1, 1, 1)
        self.nsel = torch.arange(self.n, device=dev).view(-1, 1, 1, 1, 1)
        self.gsel = torch.arange(g, device=dev).view(1, 1, 1, 1, g)

    def taps(self, ts: slice):
        """Taps ``ts``' geometry: the axes of :func:`_axis`, the row of each
        one's low corner in the table and ``corner(a, b)``, the values at
        the shift (a, b) from it (N, Ho, Wo, taps, g, C/g)."""
        off = self.off[:, :, :, ts]
        dy = self.dy[ts].view(1, 1, 1, -1, 1)
        dx = self.dx[ts].view(1, 1, 1, -1, 1)
        if self.window is None:
            ay = _axis(self.oy * self.stride + dy, off[..., 0], self.h, None)
            ax = _axis(self.ox * self.stride + dx, off[..., 1], self.w, None)
        else:
            ay = _axis((self.oy, dy), off[..., 0], self.h, self.window)
            ax = _axis((self.ox, dx), off[..., 1], self.w, self.window)
        p, g = self.pad, self.g
        row0 = ((self.nsel * self.hp + ay[0] + p) * self.wp + ax[0] + p) * g \
            + self.gsel

        def corner(a: int, b: int) -> torch.Tensor:
            return self.table[row0 + (a * self.wp + b) * g]
        return ay, ax, row0, corner

    def sample(self, ay, ax, corner):
        """The taps' samples (N, Ho, Wo, taps, g, C/g), before the mask:
        zero off the plane."""
        e = (lambda v: v.to(self.cd)[..., None])
        _, wy0, wy1, iny, _, _ = ay
        _, wx0, wx1, inx, _, _ = ax
        s = (e(wy0) * (e(wx0) * corner(0, 0) + e(wx1) * corner(0, 1)) +
             e(wy1) * (e(wx0) * corner(1, 0) + e(wx1) * corner(1, 1)))
        return s * e(iny & inx)

    def taps_mask(self, ts: slice) -> Optional[torch.Tensor]:
        return None if self.mask is None else self.mask[:, :, :, ts]


def _tap_weights(weights: torch.Tensor, k: int) -> torch.Tensor:
    """HWIO (k, k, C, C_out) -> (k*k, C, C_out), tap-major as the offsets."""
    return weights.reshape(k * k, weights.shape[2], weights.shape[3])


class _ExactDeformConv(torch.autograd.Function):
    """The exact-gather DCN (``window=None``) and the windowed DCNv2
    (``window=D``): the forward samples every tap in one pass and contracts
    the (taps x C) samples with the weight in one product; the backward
    recomputes ``BWD_TAPS`` taps at a time from the inputs, so only that
    many taps' samples are live (JAX scans them one at a time)."""

    BWD_TAPS = 3

    @staticmethod
    def forward(ctx, x, offsets, mask, weights, k, stride, padding,
                dilation, g, window):
        sm = _Sampler(x, offsets, mask, k, stride, padding, dilation, g,
                      window)
        m = sm.n * sm.ho * sm.wo
        every = slice(0, k * k)
        ay, ax, _, corner = sm.taps(every)
        s = sm.sample(ay, ax, corner)
        mk = sm.taps_mask(every)
        if mk is not None:
            s = s * mk.to(sm.cd)[..., None]
        out = s.reshape(m, -1) @ weights.to(sm.cd).reshape(-1,
                                                           weights.shape[3])
        ctx.save_for_backward(x, offsets, mask, weights)
        ctx.conf = (k, stride, padding, dilation, g, window)
        return out.reshape(sm.n, sm.ho, sm.wo, -1).to(x.dtype)

    @staticmethod
    def backward(ctx, d_out):
        x, offsets, mask, weights = ctx.saved_tensors
        k, stride, padding, dilation, g, window = ctx.conf
        sm = _Sampler(x, offsets, mask, k, stride, padding, dilation, g,
                      window)
        cd, c, cg = sm.cd, sm.c, sm.c // g
        wt = _tap_weights(weights, k).to(cd)
        m = sm.n * sm.ho * sm.wo
        d_out = d_out.reshape(m, -1).to(cd)
        d_table = torch.zeros_like(sm.table)
        d_w = torch.empty_like(wt)
        # (N, Ho, Wo, taps, g[, 2]), tap-major as the sampler
        d_off = torch.empty(sm.n, sm.ho, sm.wo, k * k, g, 2,
                            dtype=torch.float32, device=x.device)
        d_mask = None if mask is None else torch.empty(
            sm.n, sm.ho, sm.wo, k * k, g, dtype=cd, device=x.device)
        e = (lambda v: v.to(cd)[..., None])
        for t0 in range(0, k * k, _ExactDeformConv.BWD_TAPS):
            ts = slice(t0, min(t0 + _ExactDeformConv.BWD_TAPS, k * k))
            nt = ts.stop - ts.start
            ay, ax, row0, corner = sm.taps(ts)
            a = sm.sample(ay, ax, corner)
            mk = sm.taps_mask(ts)
            s = a if mk is None else a * e(mk)
            d_w[ts] = (s.reshape(m, nt * c).t() @ d_out).reshape(nt, c, -1)
            d_s = (d_out @ wt[ts].reshape(nt * c, -1).t()).reshape(a.shape)
            if mk is not None:
                d_mask[:, :, :, ts] = (d_s * a).sum(-1)
                d_s = d_s * e(mk)
            _, wy0, wy1, iny, gy, chy = ay
            _, wx0, wx1, inx, gx, chx = ax
            d_s = d_s * e(iny & inx)
            for (a_, b_), wgt in (((0, 0), wy0 * wx0), ((0, 1), wy0 * wx1),
                                  ((1, 0), wy1 * wx0), ((1, 1), wy1 * wx1)):
                d_table.index_add_(0, (row0 + (a_ * sm.wp + b_) * g).reshape(
                    -1), (d_s * e(wgt)).reshape(-1, cg))
            d_y = sum(e(coef) * (e(wx0) * corner(a_, 0) +
                                 e(wx1) * corner(a_, 1))
                      for a_, coef in gy)
            d_x = sum(e(coef) * (e(wy0) * corner(0, b_) +
                                 e(wy1) * corner(1, b_))
                      for b_, coef in gx)
            d_y, d_x = (d_s * d_y).sum(-1), (d_s * d_x).sum(-1)
            if window is not None:
                d_y, d_x = d_y * chy, d_x * chx
            d_off[:, :, :, ts, :, 0], d_off[:, :, :, ts, :, 1] = d_y, d_x
        p = sm.pad
        d_x_in = d_table.reshape(sm.n, sm.hp, sm.wp, c)[
            :, p:p + sm.h, p:p + sm.w]
        return (d_x_in.to(x.dtype).contiguous(),
                d_off.transpose(3, 4).reshape(offsets.shape).to(
                    offsets.dtype),
                None if mask is None else d_mask.transpose(3, 4).reshape(
                    mask.shape).to(mask.dtype),
                d_w.reshape(weights.shape).to(weights.dtype),
                None, None, None, None, None, None)


def _check_dcn(name, x, offsets, mask, weights, k, g, ho, wo):
    n, _, _, c = x.shape
    expect = (n, ho, wo, 2 * g * k * k)
    if tuple(offsets.shape) != expect or c % g or tuple(
            weights.shape[:3]) != (k, k, c):
        raise ValueError(f'{name}: x {tuple(x.shape)}, offsets '
                         f'{tuple(offsets.shape)}, weights '
                         f'{tuple(weights.shape)}: expected offsets {expect},'
                         f' HWIO weights ({k}, {k}, {c}, C_out) and C '
                         f'divisible by {g}')
    if mask is not None and tuple(mask.shape) != expect[:3] + (g * k * k,):
        raise ValueError(f'{name}: mask {tuple(mask.shape)}, expected '
                         f'{expect[:3] + (g * k * k,)}')


def deform_conv2d_exact(x: torch.Tensor, offsets: torch.Tensor,
                        weights: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        kernel_size: int = 3, stride: int = 1,
                        padding: int = 1, dilation: int = 1,
                        deform_groups: int = 1) -> torch.Tensor:
    """The exact-gather DCN (JAX ``deform_conv2d(window=None, mask=)``):
    ``x`` (N, H, W, C), ``offsets`` (N, Ho, Wo, 2*g*k*k) laid out
    (g, kh, kw, [dy, dx]), HWIO ``weights`` (k, k, C, C_out), the DCNv2
    ``mask`` (N, Ho, Wo, g*k*k), already sigmoided -> (N, Ho, Wo, C_out).
    A sample is bilinear on the plane, zero where its position falls
    outside (-1, extent) on either axis; offsets are unbounded. Positions
    are fp32, values fp32 (fp64 for an fp64 ``x``); the output takes the
    type of ``x``. Differentiable in ``x``, the offsets, the mask and the
    weights."""
    n, h, w, _ = x.shape
    k = kernel_size
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    _check_dcn('deform_conv2d_exact', x, offsets, mask, weights, k,
               deform_groups, ho, wo)
    return _ExactDeformConv.apply(
        x.contiguous(), offsets.contiguous(),
        None if mask is None else mask.contiguous(), weights, k, stride,
        padding, dilation, deform_groups, None)


def modulated_deform_conv2d(x: torch.Tensor, offsets: torch.Tensor,
                            mask: torch.Tensor, weights: torch.Tensor,
                            kernel_size: int = 3, padding: int = 1,
                            dilation: int = 1, deform_groups: int = 1,
                            window: int = 3) -> torch.Tensor:
    """The windowed DCNv2 (JAX ``modulated_deform_conv2d``, stride 1):
    arguments as :func:`deform_conv2d_exact` with a (N, H, W, g*k*k)
    ``mask``. Each tap's displacement (its place in the kernel plus its
    offset) is clipped to ``±window`` before the bilinear sample; the
    sample is zero where the unclipped position falls outside (-1,
    extent). Differentiable as :func:`deform_conv2d_exact`, with JAX's
    rules at integer displacements and at the clip's bounds (3ak)."""
    n, h, w, _ = x.shape
    k = kernel_size
    _check_dcn('modulated_deform_conv2d', x, offsets, mask, weights, k,
               deform_groups, h, w)
    if 2 * padding != dilation * (k - 1):
        raise ValueError('modulated_deform_conv2d: the windowed form keeps '
                         'the map size (padding = dilation * (k - 1) / 2)')
    return _ExactDeformConv.apply(
        x.contiguous(), offsets.contiguous(), mask.contiguous(), weights, k,
        1, padding, dilation, deform_groups, window)
