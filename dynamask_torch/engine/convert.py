"""Carry the JAX package's weights into the port.

:func:`load_jax_variables` fills a port model from the JAX detector's
``{'params': ..., 'batch_stats': ...}`` (nested dicts of numpy arrays) so that
both compute the same function. Port modules use the mmdet ``state_dict``
names, so the key map below is the port's own copy of the one in
``dynamask_tpu/engine/pretrained.py:_mmdet_key`` (:120-215), restricted to
the modules the port has, and run in the other direction. It also maps the
RefineMask leaves that the JAX importer has no rule for (the semantic
tower and logits, ``semantic_transform_out``, the ``MultiBranchFusion``
convs, ``SimpleRefineMaskHead``'s per-stage logits), and the cascade
heads' (each stage's box and mask head, ``conv_res``, HTC's semantic
head), the two-stage options' (the FPN's and the heads' GroupNorms,
the box head's shared convs, CARAFE's encoders, Double-Head's branches)
the single-stage detectors' (the dense heads, the FPN's extra convs
and BatchNorms) and those of HRNet, Res2Net, HRFPN and PAFPN (HRNet's
stem, transitions, branches and fuse layers, Res2Net's stem, split convs
and projections, HRFPN's reduction conv, PAFPN's bottom-up convs), which
that importer skips (ROADMAP.md queue 3, 3d, 3o, 3t, 3aa, 3ah):

* conv kernels HWIO -> OIHW (the DCN leaf is named ``weight``, and a
  ``ClassSelectConv1x1`` is a ``(1, 1, C, ncls)`` kernel); the FCN mask
  head's transposed conv (kh, kw, in, out) -> (in, out, kh, kw), both
  spatial axes flipped;
* dense ``(in, out)`` -> ``(out, in)``; the first box-head fc and
  ``MaskPre.fc1`` also reorder their input from HWC- to CHW-flattening;
* BatchNorm ``scale``/``bias``/``mean``/``var``; GroupNorm ``scale``/
  ``bias``, no statistics;
* a dense head's ``scales`` vector -> one ``Scale`` a level;
* ``detail_fuse_weights`` (2,) -> the loss module's (1, 2, 1, 1) kernel;
* a backbone's or FCOS's deformable conv: mmcv's ``<conv>.weight`` is
  JAX's ``<conv>_weight`` beside the block's convs (FCOS's
  ``{cls,reg}_dcn_weight``), HWIO, or RegNet's grouped (g, 3, 3, C_in/g,
  C_out/g); ``<conv>.conv_offset`` is ``<conv>_offset``
  (``{cls,reg}_dcn_offset``); the JAX importer leaves these at init
  (ROADMAP.md queue 3, 3al);
* a block plugin under mmdet's name (``context_block``,
  ``gen_attention_block``) is JAX's ``{position}_plugin{i}``:
  ``ContextBlock``'s ``channel_add_conv.{0,1,3}`` are the dense
  ``channel_add_fc1``, the LayerNorm ``channel_add_ln`` and
  ``channel_add_fc2`` (1x1 convs and a (C, 1, 1) affine in mmcv);
  ``GeneralizedAttention``'s flat ``appr_bias`` / ``geom_bias`` are JAX's
  (heads, C / heads). The JAX importer has no rule for them (3al);
* guided anchoring's heads: ``conv_loc``, ``conv_shape`` (and GA-RPN's
  ``conv_cls`` / ``conv_reg``) under their own names, a
  ``FeatureAdaption``'s ``conv_offset`` and its ``conv_adaption.weight``,
  JAX's raw ``weight`` leaf (HWIO);
* DetectoRS: a SAC ``conv2`` is JAX's ``sac_conv2`` (its ``weight`` and
  ``weight_diff`` raw HWIO leaves, ``switch``, ``pre_context``,
  ``post_context``, ``offset_s``, ``offset_l``), a block's ``rfp_conv``
  its own; the RFP's backbones ``neck.rfp_modules.{i}`` are JAX's
  ``neck/rfp_backbones_{i}``, its FPN's convs sit under ``neck/fpn``,
  ``rfp_aspp.aspp.{i}`` is ``rfp_aspp/aspp_{i}``, ``rfp_weight`` its own
  (the JAX importer skips or misplaces these, ROADMAP.md queue 3, 3ax).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_DETAIL_KERNEL = 'roi_head.mask_head.loss_func.detail_target.fuse_kernel'


def _resnet_key(key: str) -> Optional[Tuple[List[str], str]]:
    """A ResNet key's JAX path: mmdet's GroupNorms (``gn1``...) are the JAX
    ``bn1``...; the deep stem's ``stem.{0,1,3,4,6,7}`` are ``stem_conv{i}``
    / ``stem_bn{i}``, which the JAX importer has no rule for (ROADMAP.md
    queue 3)."""
    m = re.match(r'^(conv1|bn1|gn1)\.(.+)$', key)
    if m:
        return [m.group(1).replace('gn', 'bn')], m.group(2)
    m = re.match(r'^stem\.([0-8])\.(.+)$', key)
    if m and int(m.group(1)) % 3 < 2:
        i = int(m.group(1))
        return [f'stem_{("conv", "bn")[i % 3]}{i // 3 + 1}'], m.group(2)
    m = re.match(r'^layer(\d+)\.(\d+)\.(conv\d|bn\d|gn\d|rfp_conv)\.(.+)$',
                 key)
    if m:
        s, b, mod, leaf = m.groups()
        return [f'layer{s}_block{b}', mod.replace('gn', 'bn')], leaf
    m = re.match(r'^layer(\d+)\.(\d+)\.downsample\.(\d)\.(.+)$', key)
    if m:
        s, b, idx, leaf = m.groups()
        mod = 'downsample_conv' if idx == '0' else 'downsample_bn'
        return [f'layer{s}_block{b}', mod], leaf
    return None


_BN_LEAF = r'(weight|bias|running_mean|running_var)'


def _conv_bn(i: str) -> str:
    """JAX's ``ConvBN`` member of a torch ``Sequential(conv, bn[, relu])``
    index."""
    return ('conv', 'bn')[int(i)]


def _hrnet_key(key: str) -> Optional[Tuple[List[str], str]]:
    """An HRNet key's JAX path (``dynamask_tpu/models/hrnet.py``): the
    stem's ``conv{1,2}`` / ``bn{1,2}`` are ``stem_conv{1,2}/{conv,bn}``,
    the transitions ``transition{t}_{i}``, a module's blocks
    ``stage{s}_module{m}/branch{b}_block{k}`` and its fuse layers
    ``fuse_{i}_{j}`` (j > i) or ``fuse_{i}_{j}_{k}`` (j < i); ``layer1``
    is a ResNet's."""
    m = re.match(r'^(conv|bn)([12])\.(.+)$', key)
    if m:
        return [f'stem_conv{m[2]}', m[1]], m[3]
    m = re.match(r'^transition(\d)\.(\d+)\.(?:0\.)?([01])\.(.+)$', key)
    if m:
        return [f'transition{m[1]}_{m[2]}', _conv_bn(m[3])], m[4]
    m = re.match(r'^stage(\d)\.(\d+)\.branches\.(\d+)\.(\d+)\.(conv\d|bn\d)'
                 r'\.(.+)$', key)
    if m:
        return [f'stage{m[1]}_module{m[2]}', f'branch{m[3]}_block{m[4]}',
                m[5]], m[6]
    m = re.match(r'^stage(\d)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.'
                 r'(?:(\d+)\.)?([01])\.(.+)$', key)
    if m:
        s, mod, i, j, k, idx, leaf = m.groups()
        name = f'fuse_{i}_{j}' + (f'_{k}' if int(j) < int(i) else '')
        return [f'stage{s}_module{mod}', name, _conv_bn(idx)], leaf
    return _resnet_key(key) if key.startswith('layer1.') else None


def _res2net_key(key: str) -> Optional[Tuple[List[str], str]]:
    """A Res2Net key's JAX path (``dynamask_tpu/models/res2net.py``): a
    block's ``convs.{i}`` / ``bns.{i}`` are ``conv2_{i}`` / ``bn2_{i}``,
    its ``downsample.{1,2}`` (after the pool) the projection's conv and
    BN; the deep stem and the other convs are a ResNet's."""
    m = re.match(r'^layer(\d+)\.(\d+)\.(convs|bns)\.(\d+)\.(.+)$', key)
    if m:
        s, b, kind, i, leaf = m.groups()
        return [f'layer{s}_block{b}', f'{kind[:-1]}2_{i}'], leaf
    m = re.match(r'^layer(\d+)\.(\d+)\.downsample\.([12])\.(.+)$', key)
    if m:
        s, b, idx, leaf = m.groups()
        return [f'layer{s}_block{b}', ('downsample_conv', 'downsample_bn')[
            int(idx) - 1]], leaf
    return _resnet_key(key)


# the backbones whose keys differ from a ResNet's, by class name
_BACKBONE_KEYS = {'HRNet': _hrnet_key, 'Res2Net': _res2net_key}

# a plugin's keys below its module: (JAX module, leaf, hints)
_PLUGIN_KEYS = (
    (r'^conv_mask\.(weight|bias)$', lambda m: (['conv_mask'], m[1], {})),
    (r'^channel_add_conv\.0\.(weight|bias)$',
     lambda m: (['channel_add_fc1'], m[1], {'unit_dims': 2} if m[1] ==
                'weight' else {})),
    (r'^channel_add_conv\.1\.(weight|bias)$',
     lambda m: (['channel_add_ln'], m[1], {'unit_dims': 2})),
    (r'^channel_add_conv\.3\.(weight|bias)$',
     lambda m: (['channel_add_fc2'], m[1], {'unit_dims': 2} if m[1] ==
                'weight' else {})),
    (r'^(query_conv|key_conv|value_conv|proj_conv|appr_geom_fc_x|'
     r'appr_geom_fc_y)\.weight$', lambda m: ([m[1]], 'weight', {})),
    (r'^(appr_bias|geom_bias)$', lambda m: ([], m[1], {})),
)


_SAC_PARTS = (r'^(switch|pre_context|post_context|offset_s|offset_l)\.'
              r'(weight|bias)$')


def _module_key(key: str, dcn, plugins, sac=frozenset()):
    """The key of a deformable conv, a plugin or a SAC conv (module names
    of :func:`key_hints`), or None."""
    for name in sac:
        if key.startswith(name + '.'):
            owner, _, _ = name.rpartition('.')
            path = _block_path(owner) + ['sac_conv2']
            rest = key[len(name) + 1:]
            if rest in ('weight', 'weight_diff'):
                return path, 'weight', {'flax_leaf': rest}
            m = re.match(_SAC_PARTS, rest)
            return None if m is None else (path + [m[1]], m[2], {})
    mod, _, leaf = key.rpartition('.')
    offset = mod.endswith('.conv_offset')
    conv_mod = mod[:-len('.conv_offset')] if offset else mod
    if conv_mod in dcn:
        owner, _, conv = conv_mod.rpartition('.')
        m = re.match(r'^bbox_head\.(cls|reg)_convs\.\d+$', owner)
        if m:
            path, name = ['bbox_head'], f'{m[1]}_dcn'
        else:
            path, name = _block_path(owner), conv
        if offset:
            return path + [f'{name}_offset'], leaf, {}
        return path, 'weight', {'flax_leaf': f'{name}_weight'}
    for prefix, jax_name in plugins.items():
        if key.startswith(prefix + '.'):
            rest = key[len(prefix) + 1:]
            for pattern, fn in _PLUGIN_KEYS:
                m = re.match(pattern, rest)
                if m:
                    sub, leaf, hints = fn(m)
                    owner = prefix.rpartition('.')[0]
                    return _block_path(owner) + [jax_name] + sub, leaf, hints
    return None


def _block_path(owner: str) -> List[str]:
    """``backbone.layer{s}.{b}`` -> JAX's ``['backbone',
    'layer{s}_block{b}']``; an RFP backbone's ``neck.rfp_modules.{i}.
    layer{s}.{b}`` -> ``['neck', 'rfp_backbones_{i}', ...]``."""
    m = re.match(r'^(backbone|neck\.rfp_modules\.(\d+))\.layer(\d+)\.(\d+)$',
                 owner)
    if m is None:
        raise KeyError(f'no JAX block for {owner}')
    return _rfp_root(m[2]) + [f'layer{m[3]}_block{m[4]}']


def _rfp_root(i: Optional[str]) -> List[str]:
    return ['backbone'] if i is None else ['neck', f'rfp_backbones_{i}']


def _fpn_conv(i: str, num_laterals: Optional[int], norm: bool = False
              ) -> str:
    """The JAX name of the FPN's ``fpn_convs.{i}`` (or of its norm): an
    output conv below the laterals' count, an extra conv from there."""
    n = int(i)
    if num_laterals is not None and n >= num_laterals:
        return f'extra_{"gn" if norm else "conv"}_{n - num_laterals}'
    return f'fpn_{"gn" if norm else "conv"}_{n}'


def mmdet_key(key: str, num_laterals: Optional[int] = None,
              backbone: Optional[str] = None, dcn=frozenset(),
              plugins: Optional[Dict[str, str]] = None, sac=frozenset(),
              fpn: Tuple[str, ...] = ('neck',)
              ) -> Optional[Tuple[List[str], str, Dict]]:
    """Port state-dict key -> (JAX tree path, torch leaf name, hints).
    ``num_laterals`` is the FPN's (:func:`neck_laterals`): its
    ``fpn_convs`` from there on are JAX's ``extra_conv_{i}``. ``backbone``
    is the backbone's class name (:func:`key_hints`): HRNet's and
    Res2Net's keys map by their own rules, the others' as a ResNet's.
    ``dcn`` names the model's deformable convs, ``plugins`` maps each
    block plugin's module name to its JAX name, ``sac`` names the SAC
    convs, ``fpn`` is the JAX path of the FPN's convs (DetectoRS' RFP
    holds its FPN as ``neck/fpn``) (:func:`key_hints`)."""
    special = _module_key(key, dcn, plugins or {}, sac)
    if special is not None:
        return special
    if key.startswith('backbone.'):
        r = _BACKBONE_KEYS.get(backbone, _resnet_key)(key[len('backbone.'):])
        return None if r is None else (['backbone'] + r[0], r[1], {})
    m = re.match(r'^neck\.rfp_modules\.(\d+)\.(.+)$', key)
    if m:
        r = _resnet_key(m[2])
        return None if r is None else (_rfp_root(m[1]) + r[0], r[1], {})
    fpn = list(fpn)
    rules = [
        # DetectoRS' RFP: the ASPP's convs and the fusion gate
        (r'^neck\.rfp_aspp\.aspp\.(\d+)\.(weight|bias)$',
         lambda m: (['neck', 'rfp_aspp', f'aspp_{m[1]}'], m[2], {})),
        (r'^neck\.rfp_weight\.(weight|bias)$',
         lambda m: (['neck', 'rfp_weight'], m[1], {})),
        # guided anchoring's heads (JAX guided_anchor.py): the 1x1 location,
        # shape, objectness and delta convs, each FeatureAdaption's offset
        # conv and deformable kernel (a raw ``weight``)
        (r'^rpn_head\.(conv_loc|conv_shape|conv_cls|conv_reg)\.'
         r'(weight|bias)$', lambda m: (['rpn_head', m[1]], m[2], {})),
        (r'^bbox_head\.(conv_loc|conv_shape)\.(weight|bias)$',
         lambda m: (['bbox_head', m[1]], m[2], {})),
        (r'^(rpn_head|bbox_head)\.(feature_adaption(?:_cls|_reg)?)\.'
         r'conv_offset\.weight$',
         lambda m: ([m[1], m[2], 'conv_offset'], 'weight', {})),
        (r'^(rpn_head|bbox_head)\.(feature_adaption(?:_cls|_reg)?)\.'
         r'conv_adaption\.weight$',
         lambda m: ([m[1], m[2]], 'weight', {'flax_leaf': 'weight'})),
        # HRFPN's reduction conv, PAFPN's bottom-up convs (mmdet's
        # ``pafpn_convs[i - 1]`` is level i's, JAX's ``pafpn_conv_{i}``)
        (r'^neck\.reduction_conv\.conv\.(weight|bias)$',
         lambda m: (['neck', 'reduction_conv'], m[1], {})),
        (r'^neck\.downsample_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['neck', f'downsample_conv_{m[1]}'], m[2], {})),
        (r'^neck\.pafpn_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['neck', f'pafpn_conv_{int(m[1]) + 1}'], m[2], {})),
        (r'^neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (fpn + [f'lateral_{m[1]}'], m[2], {})),
        (r'^neck\.fpn_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (fpn + [_fpn_conv(m[1], num_laterals)], m[2], {})),
        # the FPN's GroupNorms and BatchNorms (JAX fpn.py:37-44, both
        # named ``*_gn_*``), FPN_CARAFE's upsamplers (JAX carafe.py:88-93)
        (r'^neck\.lateral_convs\.(\d+)\.(gn|bn)\.' + _BN_LEAF + '$',
         lambda m: (fpn + [f'lateral_gn_{m[1]}'], m[3], {})),
        (r'^neck\.fpn_convs\.(\d+)\.(gn|bn)\.' + _BN_LEAF + '$',
         lambda m: (fpn + [_fpn_conv(m[1], num_laterals, True)], m[3],
                    {})),
        # the dense heads (JAX single_stage.py, atss.py, fcos.py): the
        # towers' convs and norms (RetinaSepBNHead's convs shared by its
        # levels, its BatchNorms a level), the output convs, the scales
        (r'^bbox_head\.(cls|reg)_convs\.(\d+\.)?(\d+)\.conv\.'
         r'(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_conv_{m[3]}'], m[4], {})),
        (r'^bbox_head\.(cls|reg)_convs\.(\d+)\.gn\.(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_gn_{m[2]}'], m[3], {})),
        (r'^bbox_head\.(cls|reg)_convs\.(\d+)\.(\d+)\.bn\.' + _BN_LEAF +
         '$', lambda m: (['bbox_head', f'{m[1]}_bn_{m[2]}_{m[3]}'], m[4],
                         {})),
        (r'^bbox_head\.(retina_cls|retina_reg|atss_cls|atss_reg|'
         r'atss_centerness|conv_cls|conv_reg|conv_centerness)\.'
         r'(weight|bias)$',
         lambda m: (['bbox_head', m[1]], m[2], {})),
        (r'^bbox_head\.scales\.(\d+)\.scale$',
         lambda m: (['bbox_head'], 'scale', {'index': int(m[1])})),
        (r'^neck\.upsample_modules\.(\d+)\.(channel_compressor|'
         r'content_encoder)\.(weight|bias)$',
         lambda m: (['neck', f'upsample_{m[1]}', m[2]], m[3], {})),
        (r'^rpn_head\.(rpn_conv|rpn_cls|rpn_reg)\.(weight|bias)$',
         lambda m: (['rpn_head', m[1]], m[2], {})),
        (r'^roi_head\.bbox_head\.shared_fcs\.(\d+)\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', f'shared_fc_{m[1]}'], m[2],
                    {'flatten_chw': 7} if m[1] == '0' else {})),
        (r'^roi_head\.bbox_head\.(fc_cls|fc_reg)\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', m[1]], m[2], {})),
        # Shared4Conv1FC's convs and GroupNorms (JAX bbox_head.py:49-56)
        (r'^roi_head\.bbox_head\.shared_convs\.(\d+)\.(conv|gn)\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', f'shared_{m[2]}_{m[1]}'],
                    m[3], {})),
        # Double-Head (JAX double_head.py): the residual block, the
        # Bottleneck tower, the fc branch
        (r'^roi_head\.bbox_head\.res_block\.(conv1|conv2|conv_identity)\.'
         r'(conv|bn)\.(.+)$',
         lambda m: (['roi_head', 'bbox_head', 'res_block',
                     m[1] if m[2] == 'conv' else
                     {'conv1': 'bn1', 'conv2': 'bn2',
                      'conv_identity': 'bn_identity'}[m[1]]], m[3], {})),
        (r'^roi_head\.bbox_head\.conv_branch\.(\d+)\.(conv\d|bn\d)\.(.+)$',
         lambda m: (['roi_head', 'bbox_head', f'conv_branch_{m[1]}', m[2]],
                    m[3], {})),
        (r'^roi_head\.bbox_head\.fc_branch\.(\d+)\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_head', f'fc_branch_{m[1]}'], m[2],
                    {'flatten_chw': 7} if m[1] == '0' else {})),
        # Mask R-CNN's FCN mask head (JAX pretrained.py:148-158)
        (r'^roi_head\.mask_head\.convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'conv_{m[1]}'], m[2], {})),
        (r'^roi_head\.mask_head\.upsample\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'upsample'], m[1],
                    {'deconv': True})),
        # its GroupNorms and CARAFE upsampler (JAX fcn_mask_head.py:36-50)
        (r'^roi_head\.mask_head\.convs\.(\d+)\.gn\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'gn_{m[1]}'], m[2], {})),
        (r'^roi_head\.mask_head\.upsample\.(channel_compressor|'
         r'content_encoder)\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'upsample', m[1]], m[2], {})),
        (r'^roi_head\.mask_head\.conv_logits\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'conv_logits'], m[1], {})),
        (r'^roi_head\.mask_head\.instance_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'instance_conv_{m[1]}'],
                    m[2], {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.(semantic_transform_in|'
         r'semantic_transform_out|instance_logits|detail_logits|'
         r'fuse_transform_out)\.(weight|bias)$',
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
        # RefineMask (JAX refine_mask_head.py): the semantic tower and
        # logits, each stage's MultiBranchFusion, SimpleRefineMaskHead's
        # per-stage logits
        (r'^roi_head\.mask_head\.semantic_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'semantic_conv_{m[1]}'],
                    m[2], {})),
        (r'^roi_head\.mask_head\.semantic_logits\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'semantic_logits'], m[1], {})),
        (r'^roi_head\.mask_head\.stages\.(\d+)\.fuse_conv\.1\.'
         r'(dilation_conv_\d+|merge_conv)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', f'stage_{m[1]}', 'fuse_conv_1',
                     m[2]], m[3], {})),
        (r'^roi_head\.mask_head\.stage_instance_logits\.(\d+)\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'mask_head',
                     f'stage_instance_logits_{m[1]}'], m[2], {})),
        # the cascade heads (JAX cascade_roi_head.py, htc.py): flax names a
        # tuple field's members ``bbox_head_i`` / ``mask_heads_i``;
        # Cascade Mask R-CNN's one mask head keeps the rules above
        (r'^roi_head\.bbox_head\.(\d+)\.shared_fcs\.(\d+)\.(weight|bias)$',
         lambda m: (['roi_head', f'bbox_head_{m[1]}', f'shared_fc_{m[2]}'],
                    m[3], {'flatten_chw': 7} if m[2] == '0' else {})),
        (r'^roi_head\.bbox_head\.(\d+)\.(fc_cls|fc_reg)\.(weight|bias)$',
         lambda m: (['roi_head', f'bbox_head_{m[1]}', m[2]], m[3], {})),
        (r'^roi_head\.mask_head\.(\d+)\.(convs\.(\d+)|conv_res)\.conv\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', f'mask_heads_{m[1]}',
                     f'conv_{m[3]}' if m[3] else 'conv_res'], m[4], {})),
        (r'^roi_head\.mask_head\.(\d+)\.upsample\.(weight|bias)$',
         lambda m: (['roi_head', f'mask_heads_{m[1]}', 'upsample'], m[2],
                    {'deconv': True})),
        (r'^roi_head\.mask_head\.(\d+)\.conv_logits\.(weight|bias)$',
         lambda m: (['roi_head', f'mask_heads_{m[1]}', 'conv_logits'], m[2],
                    {})),
        # HTC's FusedSemanticHead (JAX htc.py:43-88)
        (r'^roi_head\.semantic_head\.(lateral_convs|convs)\.(\d+)\.conv\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'semantic_head',
                     f'{"lateral" if m[1] == "lateral_convs" else "conv"}_'
                     f'{m[2]}'], m[3], {})),
        (r'^roi_head\.semantic_head\.(conv_embedding\.conv|conv_logits)\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'semantic_head', m[1].split('.')[0]], m[2],
                    {})),
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
        arr = _get(params, path + ['bias'])
        return arr.reshape(arr.shape + (1,) * hints.get('unit_dims', 0))
    if leaf == 'scale':                                   # Scale a level
        return _get(params, path + ['scales'])[hints['index']]
    if leaf == 'detail_fuse_kernel':
        return _get(params, path + ['detail_fuse_weights']).reshape(1, 2, 1, 1)
    if leaf in ('appr_bias', 'geom_bias'):              # (heads, d) -> flat
        return _get(params, path + [leaf]).reshape(-1)
    assert leaf == 'weight', leaf
    arr = _weight_layout(_node(params, path), hints)
    return arr.reshape(arr.shape + (1,) * hints.get('unit_dims', 0))


def _weight_layout(node, hints) -> np.ndarray:
    if 'scale' in node:                                   # BatchNorm
        return np.asarray(node['scale'], np.float32)
    kernel = np.asarray(node[hints.get('flax_leaf', 'kernel')], np.float32)
    if kernel.ndim == 5:                  # RegNet's grouped DCN kernel
        g, kh, kw, ci, co = kernel.shape
        return kernel.transpose(0, 4, 3, 1, 2).reshape(g * co, ci, kh, kw)
    if hints.get('deconv'):
        # flax ConvTranspose (kh, kw, in, out) applies its kernel in
        # convolution orientation, torch's ConvTranspose2d (in, out, kh, kw)
        # in gradient orientation: the inverse of the JAX importer's
        # transpose and spatial flip (pretrained.py:243-250)
        return np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1))
    if kernel.ndim == 4:                                  # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    s = hints.get('flatten_chw')
    if s:                                                 # HWC -> CHW rows
        out_f = kernel.shape[1]
        c = kernel.shape[0] // (s * s)
        return kernel.reshape(s, s, c, out_f).transpose(3, 2, 0, 1).reshape(
            out_f, c * s * s)
    return kernel.T


def neck_laterals(model: nn.Module) -> Optional[int]:
    """The number of the model's FPN laterals, or None without them."""
    lateral = getattr(getattr(model, 'neck', None), 'lateral_convs', None)
    return None if lateral is None else len(lateral)


def key_hints(model: nn.Module) -> Dict:
    """What :func:`mmdet_key` needs to know of ``model``: its FPN's
    laterals and JAX path, its backbone's class, its deformable convs' and
    SAC convs' module names and its block plugins' (module name -> JAX
    name)."""
    from ..models.detectors_resnet import SAConv
    from ..models.layers import DeformConv2dPack
    bb = getattr(model, 'backbone', None)
    dcn, sac, plugins = set(), set(), {}
    for name, m in model.named_modules():
        if isinstance(m, DeformConv2dPack):
            dcn.add(name)
        if isinstance(m, SAConv):
            sac.add(name)
        for _, plugin, jax_name in getattr(m, 'plugin_names', ()):
            plugins[f'{name}.{plugin}'] = jax_name
    rfp = getattr(getattr(model, 'neck', None), 'takes_images', False)
    return dict(num_laterals=neck_laterals(model),
                backbone=None if bb is None else type(bb).__name__,
                dcn=frozenset(dcn), plugins=plugins, sac=frozenset(sac),
                fpn=('neck', 'fpn') if rfp else ('neck',))


def load_jax_variables(model: nn.Module, variables: Dict) -> nn.Module:
    """Copy the JAX detector's variables into ``model`` in place.

    Raises if a port tensor has no JAX counterpart or the shapes differ, so a
    model that loads computes the JAX model's function."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    hints = key_hints(model)
    with torch.no_grad():
        for key, tensor in model.state_dict().items():
            if key.endswith('num_batches_tracked'):
                continue
            r = mmdet_key(key, **hints)
            if r is None:
                raise KeyError(f'no JAX counterpart for port tensor {key}')
            arr = _torch_layout(params, stats, *r)
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f'{key}: JAX {arr.shape} vs port '
                                 f'{tuple(tensor.shape)}')
            tensor.copy_(torch.tensor(arr))
    return model
