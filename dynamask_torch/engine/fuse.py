"""Conv+BN folding for inference (port of ``dynamask_tpu/engine/fuse.py``,
the reference's ``tools/fuse_conv_bn.py``).

Each pair folds the BatchNorm's running statistics and scale into its
convolution: ``w' = w * gamma / sqrt(var + eps)`` per output channel, and
the additive term ``beta + (b - mean) * gamma / sqrt(var + eps)`` stays
on the BatchNorm as its bias, whose statistics are neutralised as JAX
neutralises them (scale 1, mean 0, var ``1 - eps``): the module graph and
the ``state_dict``'s keys stay as they were, so a folded ``state_dict``
loads into the unfolded model.

The pairs are the ones JAX's rule folds (``_bn_name_for``, :27-33): in
one module of the JAX tree, ``convN`` with ``bnN``, ``X_conv`` with
``X_bn`` and ``conv`` with ``bn``, and only a BatchNorm with statistics.
The port's modules carry mmdet's names (``layerK.i.conv1`` / ``bn1``,
``downsample.0`` / ``.1``, the deep stem's ``stem.{0,1,3,4,6,7}``, HRNet's
fuse layers, the C4 shared head, ...), so each conv and each BatchNorm is
named in the JAX tree by the port's key map (``engine/convert.py``
``mmdet_key``) and the rule applied there. Where JAX's rule misses a pair
mmdet's ``fuse_module`` would fold (a deep stem's ``stem_conv1`` /
``stem_bn1``: ResNetV1d's, Res2Net's), the port misses it too (ROADMAP.md
queue 3, 3cf). ``eps`` is one number for every pair, as in JAX; every
BatchNorm of the port is at 1e-5."""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from .convert import key_hints, mmdet_key


def _jax_bn_name(conv_name: str) -> Optional[str]:
    """JAX's ``_bn_name_for``: ``convN`` -> ``bnN``, ``X_conv`` ->
    ``X_bn``, ``conv`` -> ``bn``, else None."""
    if conv_name.endswith('_conv'):
        return conv_name[:-5] + '_bn'
    if conv_name.startswith('conv'):
        return 'bn' + conv_name[4:]
    return None


def conv_bn_pairs(model: nn.Module) -> List[Tuple[str, str]]:
    """(conv module name, BatchNorm module name) of each pair JAX's
    ``fuse_conv_bn`` folds in the JAX twin of ``model``. Names only: a
    model on the ``meta`` device gives its pairs."""
    hints = key_hints(model)
    convs, bns = {}, {}
    for name, m in model.named_modules():
        if isinstance(m, nn.Conv2d) and not isinstance(
                m, nn.ConvTranspose2d):
            r = mmdet_key(f'{name}.weight', **hints)
            if r is not None and r[1] == 'weight' and \
                    r[2].get('flax_leaf', 'kernel') == 'kernel':
                convs[name] = tuple(r[0])
        elif isinstance(m, nn.BatchNorm2d) and m.running_mean is not None:
            r = mmdet_key(f'{name}.running_mean', **hints)
            if r is not None:
                bns[tuple(r[0])] = name
    pairs = []
    for name, path in convs.items():
        bn = _jax_bn_name(path[-1])
        if bn is not None and path[:-1] + (bn,) in bns:
            pairs.append((name, bns[path[:-1] + (bn,)]))
    return pairs


@torch.no_grad()
def fold_pair(conv: nn.Conv2d, bn: nn.BatchNorm2d, eps: float = 1e-5):
    """Fold ``bn`` into ``conv`` in place, in fp32 with JAX's order of
    operations (so an fp32 fold is JAX's bit for bit), each tensor cast
    back to its own type."""
    w = conv.weight
    mean = bn.running_mean.float()
    var = bn.running_var.float()
    gamma = bn.weight.float() if bn.weight is not None else 1.0
    beta = bn.bias.float() if bn.bias is not None else 0.0
    # variances are >= 0 in any trained checkpoint; a malformed one must
    # not poison the model with NaN. The square root is taken in float64
    # and rounded once, the correctly rounded fp32 root numpy takes (the
    # vectorised fp32 one is within 0.5 ulp, not always rounded alike)
    root = torch.sqrt((var.clamp(min=0.0) + eps).double()).float()
    factor = gamma / root
    w.copy_((w.float() * factor.reshape(-1, 1, 1, 1)).to(w.dtype))
    conv_bias = conv.bias.float() if conv.bias is not None else 0.0
    if bn.weight is not None:
        bn.weight.fill_(1.0)
    if bn.bias is not None:
        bn.bias.copy_((beta + (conv_bias - mean) * factor).to(bn.bias.dtype))
    if conv.bias is not None:
        conv.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - eps)


def fuse_conv_bn(model: nn.Module, eps: float = 1e-5
                 ) -> Tuple[nn.Module, int]:
    """(a folded copy of ``model`` in eval mode, the number of pairs
    folded) for inference; ``model`` is left as it was. Fold an fp32
    model, then cast (``make_test_fn(bf16=True)``), as JAX's CLI folds
    before ``to_bf16``."""
    fused = copy.deepcopy(model).eval()
    modules = dict(fused.named_modules())
    pairs = conv_bn_pairs(fused)
    for conv, bn in pairs:
        fold_pair(modules[conv], modules[bn], eps)
    return fused, len(pairs)
