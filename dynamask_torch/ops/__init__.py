"""Ops of the port. Four hand-written CUDA kernels, each beside its plain
PyTorch version: K1 :func:`deform_im2col_windowed` and K3
:func:`deform_col2im_windowed` (the windowed DCN's sampling and its
backward, behind the autograd function :func:`deform_conv2d`), K2
:func:`roi_align_fwd` and K4 :func:`roi_align_bwd` (RoIAlign and its
feature gradient, behind :func:`roi_align_flat`). The rest is plain PyTorch
on the device."""

from .deform_conv import (deform_col2im_windowed,
                          deform_col2im_windowed_plain, deform_conv2d,
                          deform_im2col_windowed,
                          deform_im2col_windowed_plain)
from .nms import batched_nms, multiclass_nms
from .paste import paste_masks
# ``nms`` and ``roi_align`` are not re-exported: the names stay the modules'
from .roi_align import (map_roi_levels, multilevel_roi_align, roi_align_bwd,
                        roi_align_bwd_plain, roi_align_flat, roi_align_fwd,
                        roi_align_fwd_plain, simple_roi_align)

KERNELS = {'deform_im2col_windowed': deform_im2col_windowed,
           'deform_col2im_windowed': deform_col2im_windowed,
           'roi_align_fwd': roi_align_fwd,
           'roi_align_bwd': roi_align_bwd}


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel wrapper."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ['deform_conv2d', 'deform_im2col_windowed',
           'deform_im2col_windowed_plain', 'deform_col2im_windowed',
           'deform_col2im_windowed_plain', 'batched_nms', 'multiclass_nms',
           'paste_masks', 'map_roi_levels', 'multilevel_roi_align',
           'roi_align_fwd', 'roi_align_fwd_plain', 'roi_align_bwd',
           'roi_align_bwd_plain', 'roi_align_flat', 'simple_roi_align',
           'KERNELS', 'kernel_launches', 'reset_kernel_launches']
