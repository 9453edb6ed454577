"""Carry the JAX package's weights into the port.

:func:`load_jax_variables` fills a port model from the JAX detector's
``{'params': ..., 'batch_stats': ...}`` (nested dicts of numpy arrays) so that
both compute the same function. Port modules use the mmdet ``state_dict``
names, so the key map below is the port's own copy of the one in
``dynamask_tpu/engine/pretrained.py:_mmdet_key`` (:120-215), restricted to
the modules the port has, and run in the other direction:

* conv kernels HWIO -> OIHW (the DCN leaf is named ``weight``, and a
  ``ClassSelectConv1x1`` is a ``(1, 1, C, ncls)`` kernel);
* dense ``(in, out)`` -> ``(out, in)``; the first box-head fc and
  ``MaskPre.fc1`` also reorder their input from HWC- to CHW-flattening;
* BatchNorm ``scale``/``bias``/``mean``/``var``;
* ``detail_fuse_weights`` (2,) -> the loss module's (1, 2, 1, 1) kernel.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_DETAIL_KERNEL = 'roi_head.mask_head.loss_func.detail_target.fuse_kernel'


def _resnet_key(key: str) -> Optional[Tuple[List[str], str]]:
    m = re.match(r'^(conv1|bn1)\.(.+)$', key)
    if m:
        return [m.group(1)], m.group(2)
    m = re.match(r'^layer(\d+)\.(\d+)\.(conv\d|bn\d)\.(.+)$', key)
    if m:
        s, b, mod, leaf = m.groups()
        return [f'layer{s}_block{b}', mod], leaf
    m = re.match(r'^layer(\d+)\.(\d+)\.downsample\.(\d)\.(.+)$', key)
    if m:
        s, b, idx, leaf = m.groups()
        mod = 'downsample_conv' if idx == '0' else 'downsample_bn'
        return [f'layer{s}_block{b}', mod], leaf
    return None


def mmdet_key(key: str) -> Optional[Tuple[List[str], str, Dict]]:
    """Port state-dict key -> (JAX tree path, torch leaf name, hints)."""
    if key.startswith('backbone.'):
        r = _resnet_key(key[len('backbone.'):])
        return None if r is None else (['backbone'] + r[0], r[1], {})
    rules = [
        (r'^neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['neck', f'lateral_{m[1]}'], m[2], {})),
        (r'^neck\.fpn_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['neck', f'fpn_conv_{m[1]}'], m[2], {})),
        (r'^rpn_head\.(rpn_conv|rpn_cls|rpn_reg)\.(weight|bias)$',
         lambda m: (['rpn_head', m[1]], m[2], {})),
        (r'^roi_head\.bbox_head\.shared_fcs\.(\d+)\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', f'shared_fc_{m[1]}'], m[2],
                    {'flatten_chw': 7} if m[1] == '0' else {})),
        (r'^roi_head\.bbox_head\.(fc_cls|fc_reg)\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', m[1]], m[2], {})),
        (r'^roi_head\.mask_head\.instance_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'instance_conv_{m[1]}'],
                    m[2], {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.(semantic_transform_in|'
         r'instance_logits|detail_logits|fuse_transform_out)\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'stage_{m[1]}', m[2]], m[3],
                    {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.fuse_conv\.0\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'stage_{m[1]}',
                     'fuse_conv_0'], m[2], {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.fuse_conv\.1\.conv_offset\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'stage_{m[1]}', 'fuse_conv_1',
                     'conv_offset'], m[2], {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.fuse_conv\.1\.weight$',
         lambda m: (['roi_head', 'mask_head', f'stage_{m[1]}',
                     'fuse_conv_1'], 'weight', {'flax_leaf': 'weight'})),
        (r'^roi_head\.mask_head\.(final_instance_logits|final_detail_logits)'
         r'\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', m[1]], m[2], {})),
        (r'^roi_head\.mask_predictor\.(conv1|conv2|fc2|bn1|bn2)\.(.+)$',
         lambda m: (['roi_head', 'mask_predictor', m[1]], m[2], {})),
        (r'^roi_head\.mask_predictor\.fc1\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_predictor', 'fc1'], m[1],
                    {'flatten_chw': 14})),
    ]
    if key == _DETAIL_KERNEL:
        return ['roi_head'], 'detail_fuse_kernel', {}
    for pattern, fn in rules:
        m = re.match(pattern, key)
        if m:
            return fn(m)
    return None


def _node(tree, path: List[str]):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            raise KeyError('missing JAX variable ' + '/'.join(path))
        tree = tree[p]
    return tree


def _get(tree, path: List[str]) -> np.ndarray:
    return np.asarray(_node(tree, path), np.float32)


def _torch_layout(params, stats, path, leaf, hints) -> np.ndarray:
    """The JAX leaf behind one port tensor, in the torch layout."""
    if leaf == 'running_mean':
        return _get(stats, path + ['mean'])
    if leaf == 'running_var':
        return _get(stats, path + ['var'])
    if leaf == 'bias':
        return _get(params, path + ['bias'])
    if leaf == 'detail_fuse_kernel':
        return _get(params, path + ['detail_fuse_weights']).reshape(1, 2, 1, 1)
    assert leaf == 'weight', leaf
    node = _node(params, path)
    if 'scale' in node:                                   # BatchNorm
        return np.asarray(node['scale'], np.float32)
    kernel = np.asarray(node[hints.get('flax_leaf', 'kernel')], np.float32)
    if kernel.ndim == 4:                                  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    s = hints.get('flatten_chw')
    if s:                                                 # HWC -> CHW rows
        out_f = kernel.shape[1]
        c = kernel.shape[0] // (s * s)
        return kernel.reshape(s, s, c, out_f).transpose(3, 2, 0, 1).reshape(
            out_f, c * s * s)
    return kernel.T


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy the JAX detector's variables into ``model`` in place.

    Raises if a port tensor has no JAX counterpart or the shapes differ, so a
    model that loads computes the JAX model's function."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    with torch.no_grad():
        for key, tensor in model.state_dict().items():
            if key.endswith('num_batches_tracked'):
                continue
            r = mmdet_key(key)
            if r is None:
                raise KeyError(f'no JAX counterpart for port tensor {key}')
            arr = _torch_layout(params, stats, *r)
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f'{key}: JAX {arr.shape} vs port '
                                 f'{tuple(tensor.shape)}')
            tensor.copy_(torch.tensor(arr))
    return model
