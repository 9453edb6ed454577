"""Small building blocks of the port's models (NCHW tensors, ``channels_last``
memory). Counterparts of ``dynamask_tpu/models/layers.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import interpolate_bilinear


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that also normalises against running statistics
    of another type than its scale and bias: the mixed-precision training
    step's frozen BatchNorms, whose scale and bias are cast to bf16 while
    the statistics stay fp32 (``core/fp16.py``). Torch's ``batch_norm``
    takes parameters all in the input's type or all in fp32, so the scale
    and bias go up to the statistics' type: the function flax's BatchNorm
    computes, which normalises in fp32 with the bf16 scale and bias and
    rounds once to the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b, mean = self.weight, self.bias, self.running_mean
        if (self.training or mean is None or w is None or
                w.dtype == mean.dtype):
            return super().forward(x)
        return F.batch_norm(x, mean, self.running_var, w.to(mean.dtype),
                            b.to(mean.dtype), False, 0.0, self.eps)


class ConvModule(nn.Module):
    """A conv under the ``.conv`` attribute, so state-dict keys read
    ``<name>.conv.weight`` as mmcv's ``ConvModule`` writes them."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: int = 0, bias: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              padding=padding, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def resize_bilinear_2x(x: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """Bilinear ×2 upsample of NCHW. The SFM feature upsample is
    ``nn.Upsample(bilinear)`` (align_corners False); the final logits use
    ``align_corners=True`` (``dynamask_tpu/models/layers.py:206``)."""
    h, w = x.shape[-2:]
    return interpolate_bilinear(x, 2 * h, 2 * w, align_corners)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC; free for a ``channels_last`` tensor."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in ``channels_last`` memory (no copy)."""
    return x.permute(0, 3, 1, 2)


# default initialisers of the JAX package's modules, by parameter name
# (first match wins): xavier-uniform FPN and shared fcs, N(0, 0.01) RPN and
# class scores, N(0, 0.001) box deltas, zero DCN offset convs, flax's
# default (LeCun normal over fan-in, truncated at 2 sigma) for the MSM,
# whose JAX module names no initialiser; every other conv or linear weight
# is He-normal over fan-out
_INIT_RULES = (('neck.', 'xavier'), ('rpn_head.', 0.01),
               ('bbox_head.shared_fcs', 'xavier'), ('bbox_head.fc_cls', 0.01),
               ('bbox_head.fc_reg', 0.001), ('conv_offset', 0.0),
               ('mask_predictor.', 'lecun'))
# flax's truncated normal is rescaled to keep the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _default_init(name: str, p: torch.Tensor, generator: torch.Generator):
    rule = next((r for key, r in _INIT_RULES if key in name), 'he')
    if rule == 'xavier':
        fan_in = p[0].numel()
        fan_out = p.shape[0] * (p[0, 0].numel() if p.dim() > 2 else 1)
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        p.uniform_(-bound, bound, generator=generator)
    elif rule == 'he':
        fan_out = p.shape[0] * (p[0, 0].numel() if p.dim() > 2 else 1)
        p.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=generator)
    elif rule == 'lecun':
        std = (1.0 / p[0].numel()) ** 0.5 / _TRUNC_STD
        nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    elif rule:
        p.normal_(0.0, rule, generator=generator)
    else:
        p.zero_()


def init_weights(model: nn.Module, generator: torch.Generator,
                 std: Optional[float] = None) -> nn.Module:
    """Fill every parameter and BN statistic from ``generator``.

    ``std=None``: the JAX package's initialisers (``_INIT_RULES``), zero
    biases, unit BN but for the zero scale of a BN marked ``zero_init``
    (a residual block's last: ``zero_init_residual``). ``std=s``: every
    float parameter ~ N(0, s) and BN statistics |N(0, s)| + 0.5 (the
    random-weight protocol of the JAX bench)."""
    with torch.no_grad():
        for mod_name, m in model.named_modules():
            is_bn = isinstance(m, nn.modules.batchnorm._BatchNorm)
            for name, p in m.named_parameters(recurse=False):
                if std is not None:
                    p.normal_(0.0, std, generator=generator)
                elif is_bn:
                    p.fill_(1.0 if name == 'weight' and not getattr(
                        m, 'zero_init', False) else 0.0)
                elif p.dim() >= 2:
                    # a transposed conv stores (in, out, kh, kw): its fan
                    # out is that of the (out, in, kh, kw) view
                    _default_init(f'{mod_name}.{name}', p.transpose(0, 1)
                                  if isinstance(m, nn.ConvTranspose2d)
                                  else p, generator)
                else:
                    p.zero_()
            if is_bn:
                if std is not None:
                    for buf in (m.running_mean, m.running_var):
                        buf.normal_(0.0, std, generator=generator)
                        buf.abs_().add_(0.5)
                else:
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    return model
