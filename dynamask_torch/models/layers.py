"""Small building blocks of the port's models (NCHW tensors, ``channels_last``
memory). Counterparts of ``dynamask_tpu/models/layers.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.boundary import interpolate_bilinear
from ..ops import deform_conv as dcn_ops


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


class BatchNorm2dBiasedVar(BatchNorm2d):
    """BatchNorm2d whose training mode updates the running variance with
    the biased batch variance, as the JAX package's flax BatchNorm does
    (torch's own update uses the unbiased one). Momentum 0.1 here is flax's
    0.9. The batch statistics are taken in fp32 from any input type, as
    flax's are."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked += 1
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm at flax's epsilon (1e-6), the JAX package's
    ``nn.GroupNorm`` (``dynamask_tpu/models/resnet.py:120-124``); its scale
    and bias are ``weight`` and ``bias`` as mmcv's ``GN`` names them.

    Under the bf16 policy (``core/fp16.py``) it computes what flax's does
    on a bf16 input with bf16 parameters: statistics and normalisation in
    fp32 with the bf16 scale and bias widened, one rounding to bf16 at the
    end.

    It calls the ``group_norm`` operator itself: ``F.group_norm`` refuses a
    group of one value (a dense head's 1x1 top level at one channel a
    group, one image), which flax normalises to its bias."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        low = x.dtype in (torch.bfloat16, torch.float16)
        w, b = ((self.weight.float(), self.bias.float()) if low
                else (self.weight, self.bias))
        out = torch.group_norm(x.float() if low else x, self.num_groups, w,
                               b, self.eps, torch.backends.cudnn.enabled)
        return out.to(x.dtype)


class ConvWS2d(nn.Conv2d):
    """Weight-standardised conv (mmcv's ``ConvWS2d``, the ``conv_cfg=
    ConvWS`` of the gn+ws configs; JAX ``models/layers.py:67``,
    ``WSConv``): each output channel's kernel is taken to zero mean and
    unit standard deviation over (in, kh, kw) before the convolution. The
    deviation is the biased one with 1e-5 added, as JAX's ``jnp.std``
    takes it; mmcv's ``Tensor.std`` is the unbiased one (ROADMAP.md,
    queue 3)."""

    eps = 1e-5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        flat = w.reshape(w.shape[0], -1)
        mean = flat.mean(1).reshape(-1, 1, 1, 1)
        std = flat.std(1, unbiased=False).reshape(-1, 1, 1, 1)
        return self._conv_forward(x, (w - mean) / (std + self.eps),
                                  self.bias)


class ConvModule(nn.Module):
    """A conv under the ``.conv`` attribute, so state-dict keys read
    ``<name>.conv.weight`` as mmcv's ``ConvModule`` writes them; with
    ``gn_groups`` a bias-free conv and a :class:`GroupNorm` under ``.gn``
    (mmcv's ``norm_cfg=GN``, JAX's ``nn.Conv(use_bias=False)`` +
    ``nn.GroupNorm``), with ``bn`` a bias-free conv and a flax-like
    :class:`BatchNorm2dBiasedVar` under ``.bn`` (``norm_cfg=BN``); no
    activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, padding: int = 0, bias: bool = True,
                 dilation: int = 1, stride: int = 1,
                 gn_groups: Optional[int] = None, bn: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              bias=bias and gn_groups is None and not bn,
                              dilation=dilation)
        if gn_groups is not None:
            self.gn = GroupNorm(gn_groups, out_channels)
        if bn:
            self.bn = BatchNorm2dBiasedVar(out_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, 'gn'):
            return self.gn(x)
        return self.bn(x) if hasattr(self, 'bn') else x


class WeightFaults:
    """A module that refuses, on load, a checkpoint tensor the JAX
    package's layout cannot take: :meth:`weight_fault` names why (None
    keeps the tensor to ``load_state_dict``'s own checks)."""

    def weight_fault(self, key: str, shape) -> Optional[str]:
        """Why a checkpoint tensor ``key`` (the module's own name) of
        ``shape`` is refused, or None."""
        return None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for k, v in state_dict.items():
            if k.startswith(prefix):
                fault = self.weight_fault(k[len(prefix):], v.shape)
                if fault:
                    raise ValueError(fault)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class DeformConv2dPack(nn.Module):
    """A 3x3 deformable conv with self-predicted offsets, as the JAX
    package's backbones and dense heads build it (ResNet's ``_dcn3x3``,
    ``dynamask_tpu/models/resnet.py:147-177``; RegNet's, ``regnet.py:
    93-120``; FCOS's ``dcn_on_last_conv``, ``fcos.py:83-104``), under
    mmcv's names: ``conv_offset`` (a biased conv at the stride and
    dilation, zero at init, ``2 * g * 9`` channels, ``3 * g * 9`` with
    ``modulated``: the offsets, then the mask logits) and the bias-free
    ``weight`` (C_out, C_in / ``groups``, 3, 3).

    ``modulated`` (mmcv's ``DCNv2``) scales each tap by the sigmoid of its
    mask logit. The exact gather computes it (``ops.deform_conv2d_exact``,
    unbounded offsets, any stride), but with ``square_window`` a
    stride-1 conv on a square map takes JAX's windowed form instead
    (``ops.modulated_deform_conv2d``, offsets clipped to ±3), as ResNet's
    does in JAX (ROADMAP.md queue 3). ``groups`` > 1 contracts with the
    block-diagonal dense kernel of the grouped weight, as JAX's RegNet
    assembles it."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 dilation: int = 1, deform_groups: int = 1,
                 modulated: bool = False, groups: int = 1,
                 square_window: bool = False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.deform_groups, self.modulated = deform_groups, modulated
        self.groups, self.square_window = groups, square_window
        self.conv_offset = nn.Conv2d(
            in_channels, deform_groups * (3 if modulated else 2) * 9, 3,
            stride, dilation, dilation)
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups, 3, 3))

    def dense_weight(self) -> torch.Tensor:
        """The HWIO (3, 3, C_in, C_out) kernel: block-diagonal over the
        groups."""
        w, g = self.weight, self.groups
        if g == 1:
            return w.permute(2, 3, 1, 0)
        co, ci = w.shape[0] // g, w.shape[1]
        blocks = w.reshape(g, co, ci, 3, 3).permute(0, 3, 4, 2, 1)
        dense = w.new_zeros(3, 3, ci * g, co * g)
        for i in range(g):
            dense[:, :, i * ci:(i + 1) * ci, i * co:(i + 1) * co] = blocks[i]
        return dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        off = to_nhwc(self.conv_offset(x))
        xn, w = to_nhwc(x), self.dense_weight()
        d = self.dilation
        n_off = self.deform_groups * 18
        mask = torch.sigmoid(off[..., n_off:]) if self.modulated else None
        if (self.modulated and self.square_window and self.stride == 1 and
                x.shape[-2] == x.shape[-1]):
            out = dcn_ops.modulated_deform_conv2d(
                xn, off[..., :n_off], mask, w, 3, d, d, self.deform_groups)
        else:
            out = dcn_ops.deform_conv2d_exact(
                xn, off[..., :n_off], w, mask, 3, self.stride, d, d,
                self.deform_groups)
        return to_nchw(out)


class DeformConv2d(nn.Module):
    """mmcv's ``DeformConv2d``: an exact-gather DCNv1 whose offsets come
    from outside (``ops.deform_conv2d_exact``, unbounded offsets), its
    bias-free ``weight`` (C_out, C_in, k, k) initialised N(0, 0.01) as the
    JAX dense heads' raw DCN kernels (FoveaBox's ``feature_adaption_weight``,
    RepPoints' ``reppoints_*_conv_kernel``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, deform_groups: int = 1):
        super().__init__()
        self.kernel_size, self.deform_groups = kernel_size, deform_groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.init_rule = 0.01

    def forward(self, x: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
        """NCHW ``x`` and (N, 2*g*k*k, H, W) ``offsets`` -> NCHW, stride 1,
        the map size kept."""
        k = self.kernel_size
        return to_nchw(dcn_ops.deform_conv2d_exact(
            to_nhwc(x), to_nhwc(offsets), self.weight.permute(2, 3, 1, 0),
            None, k, 1, (k - 1) // 2, 1, self.deform_groups))


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
# (first match wins; a module's own ``init_rule`` attribute comes first):
# xavier-uniform FPN, shared fcs and Double-Head's fc branch, N(0, 0.01)
# RPN and class scores, N(0, 0.001) box deltas (of every cascade stage
# too), zero DCN offset convs, flax's default (LeCun normal over fan-in,
# truncated at 2 sigma) for the MSM, for RefineMask's MultiBranchFusion
# convs and for the box head's shared convs, whose JAX modules name no
# initialiser; every other conv or linear weight is He-normal over fan-out
_INIT_RULES = (('neck.', 'xavier'), ('rpn_head.', 0.01),
               ('.shared_fcs.', 'xavier'), ('.fc_branch.', 'xavier'),
               ('.shared_convs.', 'lecun'), ('.fc_cls.', 0.01),
               ('.fc_reg.', 0.001), ('conv_offset', 0.0),
               ('mask_predictor.', 'lecun'), ('.dilation_conv_', 'lecun'),
               ('.merge_conv.', 'lecun'))
# flax's truncated normal is rescaled to keep the asked-for variance
_TRUNC_STD = 0.87962566103423978


def _default_init(name: str, p: torch.Tensor, generator: torch.Generator,
                  rule=None):
    if rule is None:
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
    biases, unit BN and GN but for the zero scale of one marked ``zero_init``
    (a residual block's last: ``zero_init_residual``), a module's
    ``init_fill`` constants by parameter name (the dense heads' prior
    class bias, a ``Scale``'s 1, a LayerNorm's affine) and its
    ``init_std`` normal draws (``GeneralizedAttention``'s biases); a
    module's ``init_buffers()`` sets its own state (Dynamic R-CNN's).
    ``std=s``: every float parameter ~ N(0, s) and BN statistics
    |N(0, s)| + 0.5 (the random-weight protocol of the JAX bench)."""
    with torch.no_grad():
        for mod_name, m in model.named_modules():
            is_norm = isinstance(m, (nn.modules.batchnorm._BatchNorm,
                                     nn.GroupNorm))
            fill = getattr(m, 'init_fill', {})
            stds = getattr(m, 'init_std', {})
            for name, p in m.named_parameters(recurse=False):
                if std is not None:
                    p.normal_(0.0, std, generator=generator)
                elif name in fill:
                    p.fill_(fill[name])
                elif name in stds:
                    p.normal_(0.0, stds[name], generator=generator)
                elif is_norm:
                    p.fill_(1.0 if name == 'weight' and not getattr(
                        m, 'zero_init', False) else 0.0)
                elif p.dim() >= 2:
                    # a transposed conv stores (in, out, kh, kw): its fan
                    # out is that of the (out, in, kh, kw) view
                    _default_init(f'{mod_name}.{name}', p.transpose(0, 1)
                                  if isinstance(m, nn.ConvTranspose2d)
                                  else p, generator,
                                  getattr(m, 'init_rule', None))
                else:
                    p.zero_()
            if hasattr(m, 'init_buffers'):      # a state of its own
                m.init_buffers()
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                if std is not None:
                    for buf in (m.running_mean, m.running_var):
                        buf.normal_(0.0, std, generator=generator)
                        buf.abs_().add_(0.5)
                else:
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
    return model
