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
  (the JAX importer skips or misplaces these, ROADMAP.md queue 3, 3ax);
* item 9's RoI heads, which the JAX importer skips (3bd): the MaskIoU
  head's convs and fcs (the first fc's input reordered as the box head's);
  PointRend's coarse ``downsample_conv``, ``fcs`` and ``fc_logits`` (its
  rows mmdet's (class, y, x) where JAX's columns are (y, x, class)) and
  its point head, and PointRefine's stage MLPs (1x1 ``Conv1d`` kernels,
  JAX's dense ``fc_{i}`` / ``fc_logits``); Grid R-CNN's ``grid_head``
  (JAX's ``grid_head_module``: the tower's biased convs and GroupNorms,
  each transition's ``{forder,sorder}_{i}_{j}_{dw,pw}``, the raw
  ``deconv{1,2}_kernel`` / ``_bias`` leaves of its grouped deconvs,
  flipped and regrouped as ``ConvTranspose2d(groups=points)``); Dynamic
  R-CNN's state buffers ``roi_head.dyn_*`` (JAX's ``batch_stats``);
* item 6's dense heads, which the JAX importer skips (3bh): GFL's
  ``gfl_cls`` / ``gfl_reg``; FoveaBox's FeatureAlign (``conv_offset``,
  JAX's ``feature_adaption_offset``; ``conv_adaption.weight``, the raw
  ``feature_adaption_weight``); RepPoints' 1x1 and 3x3 convs, its two
  DCNs (the raw ``reppoints_{cls,pts_refine}_conv_kernel``) and
  ``bbox_head.moment_transfer`` (JAX's top-level ``moment_transfer``);
  NAS-FCOS's searched head (``{cls,reg}_convs.{i}`` are JAX's
  ``{cls,reg}_op{i}``, the DCNv2s' raw ``weight`` and ``bias`` beside
  their ``conv_offset``, the GNs ``{cls,reg}_gn{i}``) and searched neck
  (``adapt_convs.{i}`` -> ``adapt_conv_{i}`` / ``adapt_bn_{i}``, each cell
  ``fpn.<cell>`` -> ``<cell>`` with its ``out_conv.bn`` JAX's ``out_bn``,
  ``extra_downsamples.{i}`` -> ``extra_conv_{i}`` / ``extra_bn_{i}``).
* item 9's last modules, which the JAX importer skips (ROADMAP.md queue 3,
  3bs): the C4 shared head ``roi_head.shared_head.layer4.{i}`` (JAX's
  ``shared_head/layer4_block{i}``, a ResNet stage's rules); the
  DeformRoIPool extractor's ``offset_fc.{0,2,4}`` and ``mask_fc`` (JAX's
  ``bbox_extractor_obj/offset_fc1``, ``offset_fc2``, ``offset_out``,
  ``mask_out``; the first fc's input reordered as the box head's);
  HourglassNet (``stem.0`` -> ``stem_conv``, ``stem.1.{b}`` ->
  ``stem_res/block_{b}``, ``hourglass_modules.{i}`` -> ``hourglass_{i}``
  with its nested ``up1`` / ``low1`` / ``low2`` / ``low3`` layers,
  ``out_convs``, ``conv1x1s``, ``remap_convs``, ``inters.{i}`` ->
  ``out_conv_{i}``, ``conv1x1_{i}``, ``remap_{i}``, ``inter_{i}/block_0``)
  and the ``CornerHead`` (``{tl,br}_pool.{i}`` -> ``{tl,br}_pool_{i}``,
  each branch's ``{tl,br}_{heat,emb,off}.{i}.{0,1}.conv`` ->
  ``{tl,br}_{heat,emb,off}_{i}/{feat,out}``).
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


def _res_block(rest: str) -> Optional[Tuple[List[str], str]]:
    """A BasicBlock's own key (``conv1.weight``, ``downsample.1.bias``...)
    -> its JAX module and leaf."""
    m = re.match(r'^(conv\d|bn\d)\.(.+)$', rest)
    if m:
        return [m[1]], m[2]
    m = re.match(r'^downsample\.([01])\.(.+)$', rest)
    if m:
        return [('downsample_conv', 'downsample_bn')[int(m[1])]], m[2]
    return None


def _hourglass_key(key: str) -> Optional[Tuple[List[str], str]]:
    """An HourglassNet key's JAX path (``dynamask_tpu/models/
    hourglass.py``)."""
    m = re.match(r'^stem\.0\.(conv|bn)\.(.+)$', key)
    if m:
        return ['stem_conv', m[1]], m[2]
    m = re.match(r'^(?:stem\.1|inters)\.(\d+)\.(.+)$', key)
    if m:
        r = _res_block(m[2])
        root = (['stem_res', f'block_{m[1]}'] if key.startswith('stem')
                else [f'inter_{m[1]}', 'block_0'])
        return None if r is None else (root + r[0], r[1])
    m = re.match(r'^(out_convs|conv1x1s|remap_convs)\.(\d+)\.(conv|bn)\.(.+)$',
                 key)
    if m:
        name = {'out_convs': 'out_conv', 'conv1x1s': 'conv1x1',
                'remap_convs': 'remap'}[m[1]]
        return [f'{name}_{m[2]}', m[3]], m[4]
    m = re.match(r'^hourglass_modules\.(\d+)\.((?:(?:up1|low1|low2|low3)\.)+)'
                 r'(\d+)\.(.+)$', key)
    if m:
        r = _res_block(m[4])
        path = [f'hourglass_{m[1]}'] + m[2].rstrip('.').split('.') + [
            f'block_{m[3]}']
        return None if r is None else (path + r[0], r[1])
    return None


# the backbones whose keys differ from a ResNet's, by class name
# SSDVGG's ``features`` Sequential: each conv's index -> JAX's name (the
# JAX importer's ``_VGG16_FEATURE_MAP`` of ``pretrained.py:84-91``, and
# fc6 / fc7, which it does not map)
_VGG_CONVS = dict(zip((0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28, 31,
                       33),
                      [f'conv{s}_{c}' for s, n in enumerate((2, 2, 3, 3, 3), 1)
                       for c in range(1, n + 1)] + ['fc6', 'fc7']))


def _ssd_vgg_key(key: str) -> Optional[Tuple[List[str], str]]:
    """An SSDVGG key's JAX path (``dynamask_tpu/models/ssd.py:70-127``):
    ``features.{i}`` -> ``conv{s}_{c}`` / ``fc6`` / ``fc7``, ``extra.{i}`` ->
    ``extra_{i}``, ``l2_norm.weight`` -> ``l2_norm``'s raw ``weight``."""
    m = re.match(r'^features\.(\d+)\.(weight|bias)$', key)
    if m and int(m[1]) in _VGG_CONVS:
        return [_VGG_CONVS[int(m[1])]], m[2]
    m = re.match(r'^extra\.(\d+)\.(weight|bias)$', key)
    if m:
        return [f'extra_{m[1]}'], m[2]
    if key == 'l2_norm.weight':
        return ['l2_norm', 'weight'], 'raw'
    return None


_BACKBONE_KEYS = {'HRNet': _hrnet_key, 'Res2Net': _res2net_key,
                  'SSDVGG': _ssd_vgg_key, 'HourglassNet': _hourglass_key}

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


# the dense heads whose keys map by rules of their own (``head`` of
# :func:`key_hints`), tried before the shared ones
_HEAD_RULES = {
    'SSDHead': (
        (r'^bbox_head\.(cls|reg)_convs\.(\d+)\.(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_conv_{m[2]}'], m[3], {})),
    ),
    'FoveaHead': (
        (r'^bbox_head\.feature_adaption\.conv_offset\.weight$',
         lambda m: (['bbox_head', 'feature_adaption_offset'], 'weight', {})),
        (r'^bbox_head\.feature_adaption\.conv_adaption\.weight$',
         lambda m: (['bbox_head'], 'weight',
                    {'flax_leaf': 'feature_adaption_weight'})),
    ),
    'RepPointsHead': (
        (r'^bbox_head\.(reppoints_cls_conv|reppoints_pts_refine_conv)\.'
         r'weight$', lambda m: (['bbox_head'], 'weight',
                                {'flax_leaf': f'{m[1]}_kernel'})),
        (r'^bbox_head\.(reppoints_pts_init_conv|reppoints_pts_init_out|'
         r'reppoints_cls_out|reppoints_pts_refine_out)\.(weight|bias)$',
         lambda m: (['bbox_head', m[1]], m[2], {})),
        (r'^bbox_head\.moment_transfer$',
         lambda m: (['moment_transfer'], 'raw', {})),
    ),
    'CornerHead': (
        (r'^bbox_head\.(tl|br)_pool\.(\d+)\.(direction1_conv|direction2_conv|'
         r'aftpool_conv|conv1|conv2)\.(conv|bn)\.' + _BN_LEAF + '$',
         lambda m: (['bbox_head', f'{m[1]}_pool_{m[2]}', m[3], m[4]], m[5],
                    {})),
        (r'^bbox_head\.(tl|br)_(heat|emb|off)\.(\d+)\.([01])\.conv\.'
         r'(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_{m[2]}_{m[3]}',
                     ('feat', 'out')[int(m[4])]], m[5], {})),
    ),
    'NASFCOSHead': (
        (r'^bbox_head\.(cls|reg)_convs\.([02])\.conv\.conv_offset\.'
         r'(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_op{m[2]}', 'conv_offset'], m[3],
                    {})),
        (r'^bbox_head\.(cls|reg)_convs\.([02])\.conv\.(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_op{m[2]}'], m[3],
                    {'flax_leaf': m[3]})),
        (r'^bbox_head\.(cls|reg)_convs\.([13])\.conv\.(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_op{m[2]}'], m[3], {})),
        (r'^bbox_head\.(cls|reg)_convs\.(\d)\.gn\.(weight|bias)$',
         lambda m: (['bbox_head', f'{m[1]}_gn{m[2]}'], m[3], {})),
    ),
}


# NAS-FPN's keys (``neck`` of :func:`key_hints`; JAX necks_extra.py:
# 142-180): the laterals, each extra level's conv, each stack's cells
_NECK_RULES = {
    'NASFPN': (
        (r'^neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['neck', f'lateral_conv_{m[1]}'], m[2], {})),
        (r'^neck\.extra_downsamples\.(\d+)\.0\.conv\.(weight|bias)$',
         lambda m: (['neck', f'extra_conv_{m[1]}'], m[2], {})),
        (r'^neck\.fpn_stages\.(\d+)\.(\w+)\.out_conv\.conv\.(weight|bias)$',
         lambda m: (['neck', f'stage{m[1]}_{m[2]}', 'out_conv', 'conv'],
                    m[3], {})),
    ),
}


def mmdet_key(key: str, num_laterals: Optional[int] = None,
              backbone: Optional[str] = None, dcn=frozenset(),
              plugins: Optional[Dict[str, str]] = None, sac=frozenset(),
              fpn: Tuple[str, ...] = ('neck',), head: Optional[str] = None,
              neck: Optional[str] = None
              ) -> Optional[Tuple[List[str], str, Dict]]:
    """Port state-dict key -> (JAX tree path, torch leaf name, hints).
    ``num_laterals`` is the FPN's (:func:`neck_laterals`): its
    ``fpn_convs`` from there on are JAX's ``extra_conv_{i}``. ``backbone``
    is the backbone's class name (:func:`key_hints`): HRNet's and
    Res2Net's keys map by their own rules, the others' as a ResNet's.
    ``dcn`` names the model's deformable convs, ``plugins`` maps each
    block plugin's module name to its JAX name, ``sac`` names the SAC
    convs, ``fpn`` is the JAX path of the FPN's convs (DetectoRS' RFP
    holds its FPN as ``neck/fpn``), ``head`` the dense head's class, whose
    own rules come first, and ``neck`` the neck's class (:func:`key_hints`):
    NAS-FPN's keys map by rules of their own, a chain's ``neck.{i}.`` as
    its member's under JAX's ``neck/necks_{i}`` (Libra's FPN, then its
    BFP's ``refine``)."""
    m = re.match(r'^neck\.(\d+)\.(.+)$', key)
    if neck == 'NeckChain' and m:
        return mmdet_key('neck.' + m[2], num_laterals, backbone, dcn, plugins,
                         sac, ('neck', f'necks_{m[1]}'), head)
    for pattern, fn in _HEAD_RULES.get(head, ()) + _NECK_RULES.get(neck, ()):
        m = re.match(pattern, key)
        if m:
            return fn(m)
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
    m = re.match(r'^roi_head\.shared_head\.(.+)$', key)
    if m:
        r = _resnet_key(m[1])
        return None if r is None else (['roi_head', 'shared_head'] + r[0],
                                       r[1], {})
    fpn = list(fpn)
    rules = [
        # the DeformRoIPool extractor (JAX roi_head.py:33-80)
        (r'^roi_head\.bbox_roi_extractor\.offset_fc\.([024])\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_extractor_obj',
                     {'0': 'offset_fc1', '2': 'offset_fc2',
                      '4': 'offset_out'}[m[1]]], m[2],
                    {'flatten_chw': 7} if m[1] == '0' else {})),
        (r'^roi_head\.bbox_roi_extractor\.mask_fc\.(weight|bias)$',
         lambda m: (['roi_head', 'bbox_extractor_obj', 'mask_out'], m[1], {})),
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
        # NAS-FCOS' searched neck (JAX nasfcos.py:44-130)
        (r'^neck\.(adapt|extra)_(?:convs|downsamples)\.(\d+)\.(conv|bn)\.'
         + _BN_LEAF + '$',
         lambda m: (['neck', f'{m[1]}_{m[3]}_{m[2]}'], m[4], {})),
        (r'^neck\.fpn\.(c\d\d(?:_\d)?)\.(input1_conv|input2_conv|out_conv)'
         r'\.conv\.weight$',
         lambda m: (['neck', m[1], m[2]], 'weight', {})),
        (r'^neck\.fpn\.(c\d\d(?:_\d)?)\.out_conv\.bn\.' + _BN_LEAF + '$',
         lambda m: (['neck', m[1], 'out_bn'], m[2], {})),
        (r'^neck\.lateral_convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (fpn + [f'lateral_{m[1]}'], m[2], {})),
        # BFP's refinement: a NonLocal2d's four 1x1 convs, or one 3x3 conv
        (r'^neck\.refine\.(g|theta|phi|conv_out)\.conv\.(weight|bias)$',
         lambda m: (fpn + ['refine', m[1]], m[2], {})),
        (r'^neck\.refine\.conv\.(weight|bias)$',
         lambda m: (fpn + ['refine'], m[1], {})),
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
         r'atss_centerness|conv_cls|conv_reg|conv_centerness|gfl_cls|'
         r'gfl_reg)\.(weight|bias)$',
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
        # item 9's heads: Mask Scoring R-CNN's MaskIoU head (JAX
        # mask_scoring.py:26-55), PointRend's coarse and point heads
        # (point_rend.py:65-126; the coarse logits' rows are mmdet's (class,
        # y, x), JAX's columns (y, x, class)), PointRefine's point MLPs
        # (point_refine_head.py:83-88), Grid R-CNN's GridHead (grid_rcnn.py:
        # 102-170, JAX's module ``grid_head_module``; its grouped deconvs
        # raw leaves), Dynamic R-CNN's state (dynamic_rcnn.py:48-67, in
        # ``batch_stats``)
        (r'^roi_head\.mask_iou_head\.convs\.(\d+)\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_iou_head', f'conv_{m[1]}'], m[2], {})),
        (r'^roi_head\.(mask_iou_head|mask_head)\.fcs\.(\d+)\.(weight|bias)$',
         lambda m: (['roi_head', m[1], f'fc_{m[2]}'], m[3],
                    {'flatten_chw': 7} if m[2] == '0' else {})),
        (r'^roi_head\.mask_iou_head\.fc_mask_iou\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_iou_head', 'fc_mask_iou'], m[1], {})),
        (r'^roi_head\.mask_head\.downsample_conv\.conv\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'downsample_conv'], m[1], {})),
        (r'^roi_head\.mask_head\.fc_logits\.(weight|bias)$',
         lambda m: (['roi_head', 'mask_head', 'fc_logits'], m[1],
                    {'rows_hwc': 7})),
        (r'^roi_head\.(point_head|mask_head\.stages\.(\d+))\.fcs\.(\d+)\.'
         r'conv\.(weight|bias)$',
         lambda m: (_point_mlp(m[1], m[2]) + [f'fc_{m[3]}'], m[4],
                    {'unit_dims': 1} if m[4] == 'weight' else {})),
        (r'^roi_head\.(point_head|mask_head\.stages\.(\d+))\.fc_logits\.'
         r'(weight|bias)$',
         lambda m: (_point_mlp(m[1], m[2]) + ['fc_logits'], m[3],
                    {'unit_dims': 1} if m[3] == 'weight' else {})),
        (r'^roi_head\.grid_head\.convs\.(\d+)\.(conv|gn)\.(weight|bias)$',
         lambda m: (['roi_head', 'grid_head_module', f'{m[2]}_{m[1]}'], m[3],
                    {})),
        (r'^roi_head\.grid_head\.(forder|sorder)_trans\.(\d+)\.(\d+)\.([01])\.'
         r'(weight|bias)$',
         lambda m: (['roi_head', 'grid_head_module',
                     f'{m[1]}_{m[2]}_{m[3]}_{("dw", "pw")[int(m[4])]}'], m[5],
                    {})),
        (r'^roi_head\.grid_head\.norm1\.(weight|bias)$',
         lambda m: (['roi_head', 'grid_head_module', 'deconv1_gn'], m[1], {})),
        (r'^roi_head\.grid_head\.(deconv[12])\.(weight|bias)$',
         lambda m: (['roi_head', 'grid_head_module'], m[2], dict(
             flax_leaf=f'{m[1]}_{"kernel" if m[2] == "weight" else "bias"}',
             grouped_deconv=m[2] == 'weight'))),
        (r'^roi_head\.(dyn_iou_thr|dyn_beta|dyn_iou_hist|dyn_beta_hist|'
         r'dyn_step)$', lambda m: (['roi_head'], 'state', {'stat': m[1]})),
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


def _point_mlp(owner: str, stage: Optional[str]) -> List[str]:
    """The JAX path of a point MLP: PointRend's ``point_head`` or a
    PointRefine stage."""
    if stage is None:
        return ['roi_head', 'point_head']
    return ['roi_head', 'mask_head', f'stage_{stage}']


def _float(a) -> np.ndarray:
    """A JAX leaf as float32, or float64 where it is (a float64 gradient
    laid out for a comparison)."""
    a = np.asarray(a)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _node(tree, path: List[str]):
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            raise KeyError('missing JAX variable ' + '/'.join(path))
        tree = tree[p]
    return tree


def _get(tree, path: List[str]) -> np.ndarray:
    return _float(_node(tree, path))


def _torch_layout(params, stats, path, leaf, hints) -> np.ndarray:
    """The JAX leaf behind one port tensor, in the torch layout."""
    if leaf == 'running_mean':
        return _get(stats, path + ['mean'])
    if leaf == 'running_var':
        return _get(stats, path + ['var'])
    if leaf == 'state':                                   # a JAX statistic
        return _get(stats, path + [hints['stat']])
    if leaf == 'bias':
        arr = _rows_chw(_get(params, path + [hints.get('flax_leaf', 'bias')]),
                        hints)
        return arr.reshape(arr.shape + (1,) * hints.get('unit_dims', 0))
    if leaf == 'raw':                                     # a bare leaf
        return _get(params, path)
    if leaf == 'scale':                                   # Scale a level
        return _get(params, path + ['scales'])[hints['index']]
    if leaf == 'detail_fuse_kernel':
        return _get(params, path + ['detail_fuse_weights']).reshape(1, 2, 1, 1)
    if leaf in ('appr_bias', 'geom_bias'):              # (heads, d) -> flat
        return _get(params, path + [leaf]).reshape(-1)
    assert leaf == 'weight', leaf
    arr = _rows_chw(_weight_layout(_node(params, path), hints), hints)
    return arr.reshape(arr.shape + (1,) * hints.get('unit_dims', 0))


def _rows_chw(arr: np.ndarray, hints) -> np.ndarray:
    """Rows (the first axis) of an (s, s, C) map in JAX's (y, x, class)
    order put in mmdet's (class, y, x) order (``rows_hwc`` s)."""
    s = hints.get('rows_hwc')
    if not s:
        return arr
    rest = arr.shape[1:]
    return np.ascontiguousarray(arr.reshape(s, s, -1, *rest).transpose(
        2, 0, 1, *range(3, 3 + len(rest))).reshape(arr.shape))


def _weight_layout(node, hints) -> np.ndarray:
    if 'scale' in node:                                   # BatchNorm
        return _float(node['scale'])
    kernel = _float(node[hints.get('flax_leaf', 'kernel')])
    if kernel.ndim == 5:                  # RegNet's grouped DCN kernel
        g, kh, kw, ci, co = kernel.shape
        return kernel.transpose(0, 4, 3, 1, 2).reshape(g * co, ci, kh, kw)
    if hints.get('grouped_deconv'):
        # JAX's grouped deconv (k, k, C_in / g, g * C_out / g), applied in
        # convolution orientation a group at a time (grid_rcnn.py:76-99):
        # torch's (C_in, C_out / g, k, k), flipped; the groups are the
        # grid's points, deconv2's outputs
        g = np.shape(node['deconv2_kernel'])[-1]
        k, _, cg, co = kernel.shape
        w = kernel[::-1, ::-1].reshape(k, k, cg, g, co // g)
        return np.ascontiguousarray(w.transpose(3, 2, 4, 0, 1).reshape(
            g * cg, co // g, k, k))
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
    """The number of the model's FPN laterals (a chain's first neck's),
    or None without them."""
    neck = getattr(model, 'neck', None)
    if type(neck).__name__ == 'NeckChain':
        neck = neck[0]
    lateral = getattr(neck, 'lateral_convs', None)
    return None if lateral is None else len(lateral)


def key_hints(model: nn.Module) -> Dict:
    """What :func:`mmdet_key` needs to know of ``model``: its FPN's
    laterals and JAX path, its backbone's class, its deformable convs' and
    SAC convs' module names, its block plugins' (module name -> JAX
    name), its dense head's class and its neck's."""
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
    neck = getattr(model, 'neck', None)
    rfp = getattr(neck, 'takes_images', False)
    head = getattr(model, 'bbox_head', None)
    return dict(num_laterals=neck_laterals(model),
                backbone=None if bb is None else type(bb).__name__,
                dcn=frozenset(dcn), plugins=plugins, sac=frozenset(sac),
                fpn=('neck', 'fpn') if rfp else ('neck',),
                head=None if head is None else type(head).__name__,
                neck=None if neck is None else type(neck).__name__)


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
