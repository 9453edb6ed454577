"""Ops of the port. Five hand-written CUDA kernels, each beside its plain
PyTorch version: K1 :func:`deform_im2col_windowed` and K3
:func:`deform_col2im_windowed` (the windowed DCN's sampling and its
backward, behind the autograd function :func:`deform_conv2d`), K2
:func:`roi_align_fwd` and K4 :func:`roi_align_bwd` (RoIAlign and its
feature gradient, behind :func:`roi_align_flat`), and K5, the fused
windowed-DCN forward (sampling and contraction in one launch), behind the
forward-only entry points :func:`deform_conv2d_windowed_fused` and
:func:`deform_conv2d_frame`. The rest is plain PyTorch on the device, the
backbones' DCNs among it (:func:`deform_conv2d_exact`,
:func:`modulated_deform_conv2d`: XLA in the JAX package, no kernel).
K1-K4 each have an fp32 and a bf16 instance, chosen by the tensors' type.
``KERNELS`` holds each kernel wrapper, K5 once per entry point; each
wrapper's ``launches`` counts its instances' launches apart, keyed by the
suffix of the instance's name ('' for fp32, ``BF16`` for bf16)."""

from .deform_conv import (BF16, deform_col2im_windowed,
                          deform_col2im_windowed_plain, deform_conv2d,
                          deform_conv2d_exact, deform_im2col_windowed,
                          deform_im2col_windowed_plain,
                          modulated_deform_conv2d)
from .deform_conv_fused import (deform_conv2d_frame,
                                deform_conv2d_fused_plain,
                                deform_conv2d_windowed_fused)
from .nms import batched_nms, multiclass_nms
from .paste import paste_masks
# ``nms`` and ``roi_align`` are not re-exported: the names stay the modules'
from .roi_align import (map_roi_levels, multilevel_roi_align, roi_align_bwd,
                        roi_align_bwd_plain, roi_align_flat, roi_align_fwd,
                        roi_align_fwd_plain, simple_roi_align)

KERNELS = {'deform_im2col_windowed': deform_im2col_windowed,
           'deform_col2im_windowed': deform_col2im_windowed,
           'roi_align_fwd': roi_align_fwd,
           'roi_align_bwd': roi_align_bwd,
           'deform_conv2d_windowed_fused': deform_conv2d_windowed_fused,
           'deform_conv2d_frame': deform_conv2d_frame}


def kernel_launches() -> dict:
    """Launch count of each hand-written kernel instance, by its name: the
    ``KERNELS`` name, with ``BF16`` appended for a bf16 instance."""
    return {name + suffix: n for name, fn in KERNELS.items()
            for suffix, n in fn.launches.items()}


def reset_kernel_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = dict.fromkeys(fn.launches, 0)


__all__ = ['deform_conv2d', 'deform_conv2d_exact', 'modulated_deform_conv2d',
           'deform_im2col_windowed',
           'deform_im2col_windowed_plain', 'deform_col2im_windowed',
           'deform_col2im_windowed_plain', 'deform_conv2d_windowed_fused',
           'deform_conv2d_frame', 'deform_conv2d_fused_plain', 'batched_nms',
           'multiclass_nms', 'paste_masks', 'map_roi_levels', 'multilevel_roi_align',
           'roi_align_fwd', 'roi_align_fwd_plain', 'roi_align_bwd',
           'roi_align_bwd_plain', 'roi_align_flat', 'simple_roi_align',
           'BF16', 'KERNELS', 'kernel_launches', 'reset_kernel_launches']
