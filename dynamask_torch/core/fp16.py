"""The mixed-precision policy (port of ``dynamask_tpu/core/fp16.py``):
bfloat16 compute with fp32 master weights, no loss scaling (bf16 keeps
fp32's exponent range).

* :func:`to_bf16` casts the floating parameters and buffers, BatchNorm
  running statistics included, as the JAX version casts ``batch_stats``;
  the test function (``apis.test.make_test_fn(..., bf16=True)``) runs a
  bf16 copy of the model on a bf16 image;
* the box and score decode casts the network's outputs back to fp32 at its
  entry (``models.rpn_head.rpn_get_proposals``,
  ``models.bbox_head.bbox_head_get_dets``): coordinates above ~256 px have
  no meaning in bf16's 8-bit mantissa;
* training (``engine.train.make_train_step(..., compute_dtype=
  torch.bfloat16)``) casts the fp32 parameters inside the differentiated
  function, so their gradients land on the fp32 masters; the BatchNorm
  running statistics stay fp32, as ``batch_stats`` do in JAX;
* a GroupNorm (``models.layers.GroupNorm``: the GN backbones, FPN and
  heads) takes its statistics and normalises in fp32, its bf16 scale and
  bias widened, and rounds to bf16 once, as flax's GroupNorm does on bf16
  inputs and parameters.
"""

from __future__ import annotations

import copy
from typing import Any

import torch


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Cast the floating tensors of ``tree`` to ``dtype``; integer and bool
    ones are left alone. ``tree`` is a tensor, a dict, list or tuple of such
    trees (a ``state_dict``, for one), or an ``nn.Module``: a module is
    copied, and the copy's floating parameters and buffers are cast; the
    module given is left as it was."""
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(dtype)
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in its own type where that is wider: a decode's
    entry, which keeps a float64 check in float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def to_bf16(tree: Any) -> Any:
    return cast_floating(tree, torch.bfloat16)


def to_f32(tree: Any) -> Any:
    return cast_floating(tree, torch.float32)
