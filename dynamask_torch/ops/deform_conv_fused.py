"""The whole windowed DCN forward in one kernel: sampling and contraction.

Port of the two TPU kernels that compute the bounded-window DCN forward
inside their own body, bilinear window sampling and the per-tap
``(channel) -> C_out`` product both:

* :func:`deform_conv2d_windowed_fused`, the counterpart of
  ``dynamask_tpu/ops/deform_conv_pallas.py:deform_conv2d_windowed_pallas``
  (:88-150, Pallas body ``_dcn_win_kernel`` :40). Its rule: everything in
  fp32 whatever the input type (:71, :76), one cast of the result to
  ``x.dtype`` (:150);
* :func:`deform_conv2d_frame`, the counterpart of
  ``deform_conv_pallas.py:deform_conv2d_frame`` (:214-293, Pallas body
  ``_dcn_frame_kernel`` :177). Its rule rounds to ``x.dtype`` at every
  step of the sampling: the tent weights and the window products
  (:189-202), the per-tap sample and the weight before the product
  (:203-207); the product accumulates in fp32.

For an fp32 ``x`` the two rules compute the same function. Both are
forward-only, as the JAX functions are (``deform_conv_pallas.py:27``),
and keep their contract: square planes, stride 1, a bounded window.

On a CUDA tensor both launch kernel K5 (``csrc/deform_conv_fused.cu``), one
launch per call, which never writes the 9x column tensor: the frame rule on
a bf16 ``x`` on the tensor cores, every other instance on the fp32 FMAs,
configured by :func:`k5_launch_config`; on a CPU tensor they run
:func:`deform_conv2d_fused_plain`. The flagship's ``DCNPack`` keeps K1 +
``torch.matmul`` (:func:`.deform_conv.deform_conv2d`), as the JAX main path
keeps ``deform_conv2d_rowmm``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .deform_conv import (_aligned, _corner_index, _geometry, _padded,
                          _refuse_grad, im2col_weight)


def _hwio_to_rows(weights: torch.Tensor, deform_groups: int) -> torch.Tensor:
    """HWIO (k, k, C, C_out) -> (g*k*k*C/g, C_out) fp32, the row order of
    the column tensor (group, tap, channel)."""
    return im2col_weight(weights.permute(3, 2, 0, 1), deform_groups).float()


def deform_conv2d_fused_plain(x: torch.Tensor, offsets: torch.Tensor,
                              weights: torch.Tensor, kernel_size: int = 3,
                              padding: int = 1, dilation: int = 1,
                              deform_groups: int = 1, window: int = 3,
                              round_to_input: bool = False) -> torch.Tensor:
    """Plain PyTorch form of K5: ``x`` (n, S, S, C), ``offsets``
    (n, S, S, 2*g*k*k) laid out ``(g, kh, kw, [dy, dx])``, HWIO ``weights``
    (k, k, C, C_out) -> (n, S, S, C_out) in ``x.dtype``.

    The samples are K1's (:func:`.deform_conv._geometry` and
    ``_corner_index``: the same inclusion, clip and tent rules). With
    ``round_to_input`` every step of the sampling and the weight are
    rounded to ``x.dtype`` as ``_dcn_frame_kernel`` does; without it all is
    fp32 and only the result is cast. The contraction is fp32."""
    n, h, w, _ = x.shape
    g = deform_groups
    _, _, ins, _, _, fy, fx, (wy0, wy1), (wx0, wx1) = _geometry(
        offsets, h, w, kernel_size, padding, dilation, g, window)
    idx, step = _corner_index(n, h, w, g, fy, fx, window)
    xg = _padded(x, window, g)
    v00, v01 = xg[idx], xg[idx + g]
    v10, v11 = xg[idx + step], xg[idx + step + g]
    if round_to_input:
        def rnd(t):
            return t.to(x.dtype).float()
    else:
        def rnd(t):
            return t
    e = (lambda t: t[..., None])
    wx0, wx1 = e(rnd(wx0)), e(rnd(wx1))
    wy0, wy1 = e(rnd(wy0 * ins)), e(rnd(wy1 * ins))
    row0 = rnd(rnd(v00 * wx0) + rnd(v01 * wx1))
    row1 = rnd(rnd(v10 * wx0) + rnd(v11 * wx1))
    col = rnd(rnd(row0 * wy0) + rnd(row1 * wy1))
    w2 = rnd(_hwio_to_rows(weights, g))
    out = torch.matmul(col.reshape(n * h * w, -1), w2)
    return out.reshape(n, h, w, -1).to(x.dtype)


# C symbol of K5 for (x.dtype, round_to_input): for fp32 the two rules are
# one function and share one instantiation
_SYMBOLS = {(torch.float32, False): 'deform_conv_fused_f32',
            (torch.float32, True): 'deform_conv_fused_f32',
            (torch.bfloat16, False): 'deform_conv_fused_bf16',
            (torch.bfloat16, True): 'deform_conv_fused_bf16_round'}

# K5's launch configuration. The constants mirror csrc/deform_conv_fused.cu,
# which checks what it is given and refuses a configuration it cannot run.
# Both kernels: a ring of 4 shared-memory stages that sampler warps fill
# and compute warps drain. The frame rule on a bf16 x, on the tensor cores:
# 32-channel chunks, 8 sampler and 8 MMA warps; (pixels, output channels)
# of a block by tile index, 64 x 256 where C_out > 128 so that no pixel is
# sampled twice there
K5_STAGES = 4
K5_MMA_BK = 32
K5_MMA_TILES = ((128, 128), (128, 64), (64, 256))
# the fp32 rule on the FMAs: (pixels, output channels, chunk channels) of a
# block by tile index; 4 sampler warps and 128 threads of 8 x 16 outputs
K5_FMA_TILES = ((128, 128, 32), (256, 64, 16))
K5_APAD = 4              # floats of pad on each sample row of the FMA kernel


def k5_launch_config(n: int, s: int, c: int, c_out: int, g: int,
                     dtype: torch.dtype, round_to_input: bool, k: int = 3,
                     aligned: bool = True) -> dict:
    """How K5 is launched on an (n, s, s, c) input with ``g`` deform groups,
    a k x k kernel and ``c_out`` output channels, in ``dtype`` under the
    frame rule (``round_to_input``) or the plane rule. ``kernel``: 'mma'
    for the frame rule on a bf16 input (tensor cores), else 'fma' (fp32
    FMAs); ``tile`` the C function's tile index, ``bm`` x ``bn`` outputs a
    block over ``bk``-channel chunks in ``stages`` shared-memory stages;
    ``grid`` (pixel tiles, output-channel tiles);
    ``smem_bytes`` of dynamic shared memory; ``vec``: the corner loads are
    16 bytes (8 bf16 channels under the frame rule, else 4 channels), where
    the group's channels come in such runs and ``x`` is 16-byte
    ``aligned``, else one channel at a time; ``cg_pad`` and ``c_out_pad``,
    the padded weight matrix's rows per (group, tap) and columns, and
    ``chunks``, the K chunks a block walks."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'k5_launch_config: float32 or bfloat16, got {dtype}')
    cg = c // g
    narrow = c_out <= 64
    if dtype == torch.bfloat16 and round_to_input:
        kernel, tile = 'mma', 2 if c_out > 128 else int(narrow)
        (bm, bn), bk = K5_MMA_TILES[tile], K5_MMA_BK
        vec = aligned and cg % 8 == 0
        smem = K5_STAGES * (bm * bk + bk * bn) * 2
    else:
        kernel, tile = 'fma', int(narrow)
        bm, bn, bk = K5_FMA_TILES[tile]
        vec = aligned and cg % 4 == 0
        smem = K5_STAGES * (bk * (bm + K5_APAD) + bk * bn) * 4
    grid = (-(-(n * s * s) // bm), -(-c_out // bn))
    cg_pad = -(-cg // bk) * bk
    return dict(kernel=kernel, tile=tile, bm=bm, bn=bn, bk=bk,
                stages=K5_STAGES, grid=grid, smem_bytes=smem,
                vec=vec, cg_pad=cg_pad, c_out_pad=grid[1] * bn,
                chunks=g * k * k * cg_pad // bk)


def k5_weight_matrix(weights: torch.Tensor, deform_groups: int,
                     cfg: dict) -> torch.Tensor:
    """HWIO ``weights`` as K5 reads them under :func:`k5_launch_config`'s
    ``cfg``: the (group, tap, channel) rows of :func:`_hwio_to_rows`, each
    (group, tap) padded with zero rows to ``cfg['cg_pad']`` and the columns
    with zeros to ``cfg['c_out_pad']``; bf16 for the tensor-core kernel,
    rounded once a call to the values the plain version's ``rnd(w2)``
    gives, else fp32."""
    dtype = torch.bfloat16 if cfg['kernel'] == 'mma' else torch.float32
    k, c_out = weights.shape[0], weights.shape[3]
    w2 = _hwio_to_rows(weights, deform_groups)
    cg = w2.shape[0] // (deform_groups * k * k)
    w2 = w2.to(dtype).reshape(deform_groups * k * k, cg, c_out)
    out = torch.zeros(deform_groups * k * k, cfg['cg_pad'], cfg['c_out_pad'],
                      dtype=dtype, device=weights.device)
    out[:, :cg, :c_out] = w2
    return out.reshape(-1, cfg['c_out_pad'])


def _check_contract(name, x, offsets, weights, kernel_size, deform_groups,
                    window):
    n, h, w, c = x.shape
    k, g = kernel_size, deform_groups
    if h != w:
        raise ValueError(f'{name}: square planes only (the SFM stages), got '
                         f'{h}x{w}')
    if window is None or window < 0:
        raise ValueError(f'{name}: a bounded window is required, got '
                         f'{window}')
    if tuple(offsets.shape) != (n, h, w, 2 * g * k * k) or c % g:
        raise ValueError(f'{name}: x {tuple(x.shape)} / offsets '
                         f'{tuple(offsets.shape)}, expected offsets '
                         f'{(n, h, w, 2 * g * k * k)} and C divisible by {g}')
    if tuple(weights.shape[:3]) != (k, k, c) or weights.dim() != 4:
        raise ValueError(f'{name}: weights {tuple(weights.shape)}, expected '
                         f'HWIO ({k}, {k}, {c}, C_out)')


def _fused(name, counter, x, offsets, weights, kernel_size, padding,
           dilation, deform_groups, window, round_to_input):
    _refuse_grad(name, x, offsets, weights)
    _check_contract(name, x, offsets, weights, kernel_size, deform_groups,
                    window)
    if x.device.type == 'cpu':
        return deform_conv2d_fused_plain(x, offsets, weights, kernel_size,
                                         padding, dilation, deform_groups,
                                         window, round_to_input)
    if x.device.type != 'cuda' or offsets.device != x.device or \
            weights.device != x.device:
        raise ValueError(f'{name}: x, offsets and weights must be on one '
                         f'CUDA device, got {x.device}, {offsets.device}, '
                         f'{weights.device}')
    symbol = _SYMBOLS.get((x.dtype, round_to_input))
    if symbol is None:
        raise TypeError(f'{name}: x must be float32 or bfloat16, got '
                        f'{x.dtype}')
    n, s, _, c = x.shape
    k, g = kernel_size, deform_groups
    x = x.contiguous()
    offsets = offsets.contiguous().float()
    c_out = weights.shape[3]
    out = torch.empty((n, s, s, c_out), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if n * s * s >= 2 ** 31:
        raise ValueError(f'{name}: {n}x{s}x{s} pixels exceed the kernel\'s '
                         '32-bit pixel index')
    cfg = k5_launch_config(n, s, c, c_out, g, x.dtype, round_to_input, k,
                           _aligned(x))
    w = k5_weight_matrix(weights, g, cfg)
    fn = getattr(_build.load('deform_conv_fused'), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15 + [
        ctypes.c_void_p]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, s, s, c, c_out, g, k, padding, dilation, window, cfg['tile'],
            int(cfg['vec']), *cfg['grid'], cfg['smem_bytes'], stream)
    if rc != 0:
        raise RuntimeError(f'{name}: kernel launch failed with CUDA error '
                           f'{rc}')
    counter.launches[''] += 1
    return out


def deform_conv2d_windowed_fused(x: torch.Tensor, offsets: torch.Tensor,
                                 weights: torch.Tensor, kernel_size: int = 3,
                                 padding: int = 1, dilation: int = 1,
                                 deform_groups: int = 1,
                                 window: int = 3) -> torch.Tensor:
    """Counterpart of ``dynamask_tpu/ops/deform_conv_pallas.py:
    deform_conv2d_windowed_pallas`` (:88): the windowed DCN forward of
    NHWC ``x`` (n, S, S, C) with offsets (n, S, S, 2*g*k*k) and HWIO
    ``weights`` -> (n, S, S, C_out) in ``x.dtype``, computed in fp32 and
    cast once. K5 on a CUDA tensor, the plain version on a CPU tensor. No
    gradient."""
    return _fused('deform_conv2d_windowed_fused',
                  deform_conv2d_windowed_fused, x, offsets, weights,
                  kernel_size, padding, dilation, deform_groups, window,
                  round_to_input=False)


deform_conv2d_windowed_fused.launches = {'': 0}   # both types, one count


def deform_conv2d_frame(x: torch.Tensor, offsets: torch.Tensor,
                        weights: torch.Tensor, kernel_size: int = 3,
                        padding: int = 1, dilation: int = 1,
                        deform_groups: int = 1,
                        window: int = 3) -> torch.Tensor:
    """Counterpart of ``dynamask_tpu/ops/deform_conv_pallas.py:
    deform_conv2d_frame`` (:214): arguments and result as
    :func:`deform_conv2d_windowed_fused`, with the frame kernel's rounding
    to ``x.dtype`` (tent weights, window products, per-tap samples and the
    weight; fp32 accumulation). K5 on a CUDA tensor, the plain version on a
    CPU tensor. No gradient."""
    return _fused('deform_conv2d_frame', deform_conv2d_frame, x, offsets,
                  weights, kernel_size, padding, dilation, deform_groups,
                  window, round_to_input=True)


deform_conv2d_frame.launches = {'': 0}   # both types, one count
