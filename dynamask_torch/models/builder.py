"""Build the port's detector from a reference-schema config (port of the
parts of ``dynamask_tpu/models/builder.py`` (the backbones :28-131,
DetectoRS' among them, HRFPN :156-160, DetectoRS' RFP :191-206, the FPN,
PAFPN and ``FPN_CARAFE`` :178-220, the GA-RPN family :826-877, the
two-stage RoI head with its box heads, losses, extractors, samplers, test
NMS and Double-Head :233-420,
the RefineMask branch :451-494, the cascade heads :531-580,
``build_detector`` :1131-1214), ``dynamask_tpu/models/
dynamask_roi_head.py:build_dynamask_roi_head`` (:422-464) and
``dynamask_tpu/models/htc.py:build_htc_roi_head`` (:385-460) that the
Mask R-CNN, Faster / Fast R-CNN, RPN, GA-RPN / GA-Faster R-CNN,
DynaMask, RefineMask, Cascade R-CNN, HTC and the two-stage option configs
use, and Mask Scoring R-CNN, PointRend, PointRefine, Grid R-CNN and
Dynamic R-CNN, the C4 detectors' shared head :355-361 with the neck-less
backbone :149-153 and the DeformRoIPool extractor :341-351, and
CornerNet :1026-1048 on HourglassNet :132-140); the single-stage
detectors (RetinaNet, FreeAnchor, GA-RetinaNet,
ATSS, FCOS) come from ``single_stage_builder.py`` over the backbone and
neck built here.

Every key that changes the model is read, or refused with the ROADMAP.md
item (§1) where its port is queued: a config the port builds computes the
JAX package's function, or does not build.

Modules are created on the ``meta`` device, materialised on the target
device, filled from an explicit ``torch.Generator``, put in eval mode and
converted to ``channels_last`` (convs then run through cuDNN in NHWC and the
kernels read the maps without a copy). ``device='meta'`` stops before the
materialisation: the model's structure without its weights.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES, DETECTORS, NECKS
from .bbox_head import (BBoxHead, ConvFCBBoxHead, Shared2FCBBoxHead,
                        Shared4Conv1FCBBoxHead)
from .carafe import FPN_CARAFE
from .cascade_roi_head import CascadeRoIHead
from .double_head import DoubleConvFCBBoxHead, DoubleHeadRoIHead
from .dynamask_head import DynaMaskHead, MaskPre
from .dynamask_roi_head import DynaMaskRoIHead
from .dynamic_rcnn import DynamicRoIHead
from .fcn_mask_head import FCNMaskHead
from .grid_rcnn import GRID_LOSS_WEIGHT, GridHead, GridRoIHead
from .htc import FusedSemanticHead, HTCMaskHead, HybridTaskCascadeRoIHead
from .layers import init_weights
from .mask_scoring import MaskIoUHead, MaskScoringRoIHead
from .point_refine_head import PointRefineMaskHead, PointRefineRoIHead
from .point_rend import CoarseMaskHead, MaskPointHead, PointRendRoIHead
from .refine_mask_head import (RefineMaskHead, RefineRoIHead,
                               SimpleRefineMaskHead, SimpleRefineRoIHead)
from .roi_head import StandardRoIHead
from .rpn_head import RPNHead

# the registered modules must be imported for their registry entries
from . import detectors, fpn, resnet  # noqa: F401
from .fpn import PAFPN
from .hrnet import HRFPN, HRNet
from .regnet import RegNet
from .res2net import Res2Net
from .resnet import DROPPED, Backbone, dcn_spec


def _cfg(d) -> dict:
    return dict(d) if d else {}


def not_ported(what: str, item) -> NotImplementedError:
    """The refusal of a config part the port lacks: ``item`` is its
    ROADMAP.md §1 item, or the text of where it stands."""
    where = (f'ROADMAP.md §1, item {item}' if isinstance(item, int)
             else item)
    return NotImplementedError(f'{what} is not ported ({where})')


# the legacy v1 keys that JAX's two-stage builder drops (ROADMAP.md queue
# 3, 3c): refused here rather than dropped
LEGACY = 'ROADMAP.md queue 3, 3c: the JAX package drops it'
# what no config file names and no ROADMAP.md item queues: refused by name
UNQUEUED = 'no config names it'


def _check_keys(what: str, cfg: dict, read, defaults=None,
                item='no item yet') -> None:
    """Refuse a key of ``cfg`` the port does not read, unless it holds the
    value the port computes with anyway (``defaults``), naming ``item``."""
    defaults = defaults or {}
    extra = sorted(k for k, v in cfg.items() if k not in read and not (
        k in defaults and v == defaults[k]))
    if extra:
        raise not_ported(f'{what} keys {extra}', item)


def _check_loss(what: str, loss: dict, types) -> dict:
    """``loss``, refused unless its type is one of ``types``."""
    loss = _cfg(loss)
    t = loss.get('type', types[0])
    if t not in types:
        raise not_ported(f'{what} {t}', 5)
    return loss


def _check_sampling(stage: str, assigner: dict, sampler: dict,
                    typed=('RandomSampler',), capped=()) -> None:
    """The port has the sampling forms the configs use: a ``RandomSampler``
    (or a type of ``typed``) over a ``MaxIoUAssigner`` without
    ``gt_max_assign_all=False`` or ``ignore_iof_thr``, and a
    ``neg_pos_ub`` only on a type of ``capped`` (the samplers JAX hands it
    to and that apply it: PISA's Score-HLR), or on the RPN's, which JAX
    drops (3bn); refuse others, naming their item."""
    t = sampler.get('type', 'RandomSampler')
    if t not in typed:
        raise not_ported(f'{stage} sampler {t}', UNQUEUED)
    if sampler.get('neg_pos_ub', -1) != -1 and t not in capped and \
            stage != 'rpn':
        raise not_ported(f'{stage} sampler {t} neg_pos_ub (JAX samples '
                         'without it)', DROPPED)
    if (not assigner.get('gt_max_assign_all', True) or
            assigner.get('ignore_iof_thr', -1) > 0):
        raise not_ported(f'{stage} assigner {assigner}', UNQUEUED)


# the norm_cfg and style the JAX builder drops for HRNet, RegNet and
# Res2Net (``builder.py:86-115``): accepted at the values JAX computes
# with, refused at any other
BN_DEFAULTS = dict(norm_cfg=dict(type='BN', requires_grad=True),
                   style='pytorch')
REGNET_KEYS = ('arch', 'stem_channels', 'strides', 'out_indices',
               'frozen_stages', 'norm_eval')
RES2NET_KEYS = ('depth', 'scales', 'base_width', 'num_stages', 'out_indices',
                'frozen_stages', 'norm_eval', 'zero_init_residual',
                'stem_channels')


def build_hrnet(cfg: dict) -> HRNet:
    """JAX reads ``extra``, ``norm_eval`` and ``frozen_stages``
    (``builder.py:86-91``) and builds Bottlenecks in stage 1 and
    BasicBlocks after, one branch more a stage, whatever the config
    says."""
    _check_keys('HRNet', cfg, ('type', 'extra', 'norm_eval', 'frozen_stages'),
                dict(BN_DEFAULTS, with_cp=False, zero_init_residual=False,
                     in_channels=3, conv_cfg=None, multiscale_output=True),
                DROPPED)
    extra = _cfg(cfg.get('extra'))
    _check_keys('HRNet extra', extra, tuple(f'stage{s}' for s in range(1, 5)),
                item=DROPPED)
    for s in range(1, 5):
        stage = _cfg(extra.get(f'stage{s}'))
        if not stage:
            continue
        want = 'BOTTLENECK' if s == 1 else 'BASIC'
        if stage.get('block', want) != want:
            raise not_ported(f'HRNet stage{s} block {stage["block"]!r} (JAX '
                             f'builds {want} there)', DROPPED)
        _check_keys(f'HRNet stage{s}', stage, (
            'block', 'num_modules', 'num_branches', 'num_blocks',
            'num_channels'), {'fuse_method': 'SUM'}, DROPPED)
        if not (stage['num_branches'] == len(stage['num_blocks']) ==
                len(stage['num_channels']) == s) or (
                s == 1 and stage['num_modules'] != 1):
            raise not_ported(f'HRNet stage{s} {stage} (JAX builds {s} '
                             'branches there, one module in stage 1)',
                             DROPPED)
    return HRNet(extra=extra, norm_eval=cfg.get('norm_eval', True),
                 frozen_stages=cfg.get('frozen_stages', -1))


def build_regnet(cfg: dict) -> RegNet:
    """JAX reads ``arch``, ``stem_channels``, ``strides``,
    ``out_indices``, ``frozen_stages``, ``norm_eval`` and the DCN keys
    (``builder.py:101-115``; a ``dcn`` without a type is DCNv2 there)."""
    dcn = _cfg(cfg.pop('dcn', None))
    with_dcn = cfg.pop('stage_with_dcn', None)    # read only with a dcn
    _check_keys('RegNet', cfg, ('type',) + REGNET_KEYS,
                dict(BN_DEFAULTS, base_channels=32), DROPPED)
    extra = {}
    if dcn:
        extra = dict(dcn=dcn_spec(dict(dcn, type=dcn.get('type', 'DCNv2'))),
                     stage_with_dcn=tuple(with_dcn if with_dcn is not None
                                          else (False, True, True, True)))
    return RegNet(**extra, **{
        k: tuple(v) if k in ('strides', 'out_indices') else v
        for k, v in cfg.items() if k in REGNET_KEYS})


def build_res2net(cfg: dict) -> Res2Net:
    """JAX reads every key but the ``norm_cfg``, ``style``, ``dcn`` and
    ``stage_with_dcn`` it pops (``builder.py:93-100``): a ``dcn`` is
    dropped there, refused here."""
    if _cfg(cfg.pop('dcn', None)):
        raise not_ported('Res2Net dcn', DROPPED)
    cfg.pop('stage_with_dcn', None)    # read only with a dcn
    _check_keys('Res2Net', cfg, ('type',) + RES2NET_KEYS, BN_DEFAULTS,
                DROPPED)
    return Res2Net(**{k: tuple(v) if k == 'out_indices' else v
                      for k, v in cfg.items() if k in RES2NET_KEYS})


# the DetectoRS backbone's keys that JAX reads (``builder.py:116-131``);
# ``conv_cfg`` ConvAWS, which it drops, is computed as JAX computes it
# (3at), ``output_img`` is what the RFP neck's call does in both packages
DETECTORS_KEYS = ('type', 'depth', 'num_stages', 'out_indices',
                  'frozen_stages', 'norm_eval', 'stage_with_sac', 'sac',
                  'rfp_inplanes', 'groups', 'base_width', 'output_img',
                  'conv_cfg')


def build_detectors_resnet(cfg: dict):
    """``DetectoRS_ResNet`` / ``DetectoRS_ResNeXt`` as the JAX builder
    reads them, SAC in stages 2-4 by default where mmdet's default is
    none (3aw); a ``conv_cfg`` other than ConvAWS (or none) is
    refused."""
    from .detectors_resnet import DetectoRS_ResNeXt, DetectoRSResNet
    cfg.pop('pretrained', None)
    _check_keys(cfg['type'], cfg, DETECTORS_KEYS,
                dict(BN_DEFAULTS, zero_init_residual=True, with_cp=False,
                     in_channels=3, stem_channels=64, base_channels=64,
                     deep_stem=False, avg_down=False, dcn=None,
                     stage_with_dcn=(False, False, False, False),
                     plugins=None), DROPPED)
    if _cfg(cfg.get('conv_cfg')) not in ({}, {'type': 'ConvAWS'}):
        raise not_ported(f'DetectoRS conv_cfg {cfg["conv_cfg"]}', DROPPED)
    sac = _cfg(cfg.get('sac'))
    _check_keys('DetectoRS sac', sac, ('use_deform',), {'type': 'SAC'},
                DROPPED)
    resnext = cfg['type'] == 'DetectoRS_ResNeXt'
    kw = dict(depth=cfg.get('depth', 50), num_stages=cfg.get('num_stages', 4),
              out_indices=tuple(cfg.get('out_indices', (0, 1, 2, 3))),
              frozen_stages=cfg.get('frozen_stages', 1),
              norm_eval=cfg.get('norm_eval', True),
              stage_with_sac=tuple(cfg.get('stage_with_sac',
                                           (False, True, True, True))),
              sac_use_deform=sac.get('use_deform', False),
              rfp_inplanes=cfg.get('rfp_inplanes'),
              groups=cfg.get('groups', 32 if resnext else 1),
              base_width=cfg.get('base_width', 4))
    return (DetectoRS_ResNeXt if resnext else DetectoRSResNet)(**kw)


def build_backbone(cfg: dict):
    """``ResNet``, ``ResNeXt`` or ``ResNetV1d`` (``models/resnet.py``),
    ``HRNet``, ``RegNet``, ``Res2Net`` or DetectoRS' ResNet / ResNeXt."""
    cfg = _cfg(cfg)
    t = cfg.get('type')
    built = {'HRNet': build_hrnet, 'RegNet': build_regnet,
             'Res2Net': build_res2net, 'HourglassNet': build_hourglass,
             'DetectoRS_ResNet': build_detectors_resnet,
             'DetectoRS_ResNeXt': build_detectors_resnet}.get(t)
    if built:
        return built(cfg)
    if t not in BACKBONES:
        raise not_ported(f'backbone {t}', 'no item')
    cfg['out_indices'] = tuple(cfg.get('out_indices', (0, 1, 2, 3)))
    for k in ('strides', 'dilations'):
        if k in cfg:
            cfg[k] = tuple(cfg[k])
    return BACKBONES.build(cfg)


# the HourglassNet keys JAX reads (``builder.py:132-140``); its norm_cfg
# popped, taken at BN
HOURGLASS_KEYS = ('downsample_times', 'num_stacks', 'stage_channels',
                  'stage_blocks', 'feat_channel')


def build_hourglass(cfg: dict):
    """CornerNet's ``HourglassNet`` (``models/hourglass.py``)."""
    from .hourglass import HourglassNet
    cfg.pop('pretrained', None)
    _check_keys('HourglassNet', cfg, ('type',) + HOURGLASS_KEYS,
                dict(norm_cfg=dict(type='BN', requires_grad=True)), DROPPED)
    return HourglassNet(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg.items() if k in HOURGLASS_KEYS})


# the FPN keys the port reads (JAX ``fpn.py:22-35``)
FPN_KEYS = ('type', 'in_channels', 'out_channels', 'num_outs',
            'no_norm_on_lateral', 'start_level', 'end_level',
            'add_extra_convs', 'extra_convs_on_inputs',
            'relu_before_extra_convs')


def build_neck(cfg: dict):
    if not cfg:
        # the C4 detectors take the backbone's stride-16 map as it is (JAX
        # ``IdentityNeck``, builder.py:149-153)
        return torch.nn.Identity()
    if isinstance(cfg, (list, tuple)):
        # Libra R-CNN's FPN then BFP (JAX ``ChainedNeck``)
        from .necks_extra import NeckChain
        return NeckChain(*[build_neck(c) for c in cfg])
    cfg = _cfg(cfg)
    t = cfg.get('type')
    if t in ('BFP', 'NASFPN'):
        return build_extra_neck(cfg)
    if t == 'FPN_CARAFE':
        return build_fpn_carafe(cfg)
    if t == 'HRFPN':
        # JAX reads out_channels, num_outs and stride (builder.py:156-160)
        # and infers the input widths
        _check_keys('HRFPN', cfg, ('type', 'in_channels', 'out_channels',
                                   'num_outs', 'stride'),
                    dict(pooling_type='AVG', conv_cfg=None, norm_cfg=None,
                         with_cp=False), DROPPED)
        return HRFPN(tuple(cfg['in_channels']), cfg.get('out_channels', 256),
                     cfg.get('num_outs', 5), cfg.get('stride', 1))
    if t == 'PAFPN':
        # JAX's PAFPN takes the FPN's fields and computes with neither its
        # norm nor its extra convs (fpn.py:114-152)
        _check_keys('PAFPN', cfg, ('type', 'in_channels', 'out_channels',
                                   'num_outs', 'start_level', 'end_level'),
                    dict(add_extra_convs=False, extra_convs_on_inputs=True,
                         relu_before_extra_convs=False,
                         no_norm_on_lateral=False, norm_cfg=None,
                         conv_cfg=None, act_cfg=None), DROPPED)
        return PAFPN(tuple(cfg['in_channels']),
                     **{k: cfg[k] for k in ('out_channels', 'num_outs',
                                            'start_level', 'end_level')
                        if k in cfg})
    if t == 'RFP':
        return build_rfp(cfg)
    if t == 'NASFCOS_FPN':
        # JAX reads in_channels, out_channels, num_outs and start_level
        # (builder.py:174-179): the searched cells' input convs are plain
        # 3x3 convs whatever conv_cfg and norm_cfg say; the configs name
        # DCNv2 and BN, accepted as that drop (ROADMAP.md queue 3, 3bg)
        from .nasfcos import NASFCOS_FPN
        _check_keys('NASFCOS_FPN', cfg, ('type', 'in_channels',
                                         'out_channels', 'num_outs',
                                         'start_level'),
                    dict(norm_cfg={'type': 'BN'}, conv_cfg={'type': 'DCNv2'}),
                    DROPPED)
        return NASFCOS_FPN(tuple(cfg['in_channels']),
                           cfg.get('out_channels', 256),
                           cfg.get('num_outs', 5), cfg.get('start_level', 1))
    if t != 'FPN':
        raise not_ported(f'neck {t}', 'no item')
    fpn = {k: cfg.pop(k) for k in FPN_KEYS if k in cfg}
    if fpn.get('add_extra_convs') not in (None, False, True, 'on_input',
                                          'on_output'):
        raise not_ported(f'FPN add_extra_convs {fpn["add_extra_convs"]!r} '
                         '(the JAX package takes it as \'on_output\')',
                         DROPPED)
    norm_cfg = _cfg(cfg.pop('norm_cfg', None))
    if norm_cfg:
        nt = norm_cfg.get('type')
        if nt not in ('GN', 'BN', 'SyncBN'):
            raise not_ported(f'FPN norm_cfg {nt}', UNQUEUED)
        _check_keys('FPN norm_cfg', norm_cfg, ('type', 'num_groups'),
                    {'requires_grad': True}, DROPPED)
        fpn['norm'] = 'gn' if nt == 'GN' else 'bn'
        if nt == 'GN':
            fpn['gn_groups'] = norm_cfg.get('num_groups', 32)
    _check_keys('FPN', cfg, ())
    fpn['in_channels'] = tuple(fpn['in_channels'])
    return NECKS.build(fpn)


def build_extra_neck(cfg: dict):
    """Libra's ``BFP`` (JAX reads ``in_channels``, ``num_levels``,
    ``refine_level``, ``refine_type``, ``builder.py:161-165``) or
    ``NASFPN`` (``in_channels``, ``out_channels``, ``num_outs``,
    ``stack_times``, ``start_level``, :167-172; ``add_extra_convs``, which
    it drops, only at the configs' True: JAX's NAS-FPN has no other form)."""
    from .necks_extra import BFP, NASFPN
    if cfg['type'] == 'BFP':
        _check_keys('BFP', cfg, ('type', 'in_channels', 'num_levels',
                                 'refine_level', 'refine_type'),
                    {'conv_cfg': None, 'norm_cfg': None}, DROPPED)
        return BFP(cfg.get('in_channels', 256), cfg.get('num_levels', 5),
                   cfg.get('refine_level', 2), cfg.get('refine_type'))
    _check_keys('NASFPN', cfg, ('type', 'in_channels', 'out_channels',
                                'num_outs', 'stack_times', 'start_level'),
                {'add_extra_convs': True, 'end_level': -1, 'norm_cfg': None},
                DROPPED)
    return NASFPN(tuple(cfg['in_channels']), cfg.get('out_channels', 256),
                  cfg.get('num_outs', 5), cfg.get('stack_times', 7),
                  cfg.get('start_level', 0))


def build_rfp(cfg: dict):
    """DetectoRS' ``RFP`` (JAX ``builder.py:191-206``): its FPN (the
    keys JAX reads: ``in_channels``, ``out_channels``, ``num_outs``,
    ``start_level``, ``add_extra_convs``), ``rfp_steps - 1`` backbones of
    ``rfp_backbone``, the ASPP's widths and dilations."""
    from .necks_extra import RFP
    _check_keys('RFP', cfg, (
        'type', 'rfp_steps', 'rfp_backbone', 'aspp_out_channels',
        'aspp_dilations', 'in_channels', 'out_channels', 'num_outs',
        'start_level', 'add_extra_convs'), dict(
            end_level=-1, no_norm_on_lateral=False, norm_cfg=None,
            conv_cfg=None, act_cfg=None, relu_before_extra_convs=False,
            extra_convs_on_inputs=True), DROPPED)
    if cfg.get('add_extra_convs', False) not in (False, True, 'on_input'):
        raise not_ported(f'RFP add_extra_convs {cfg["add_extra_convs"]!r}',
                         DROPPED)
    return RFP(
        rfp_backbones=[build_backbone(cfg['rfp_backbone'])
                       for _ in range(cfg.get('rfp_steps', 2) - 1)],
        aspp_out_channels=cfg.get('aspp_out_channels', 64),
        aspp_dilations=tuple(cfg.get('aspp_dilations', (1, 3, 6, 1))),
        in_channels=tuple(cfg['in_channels']),
        out_channels=cfg.get('out_channels', 256),
        num_outs=cfg.get('num_outs', 5), start_level=cfg.get('start_level', 0),
        add_extra_convs=cfg.get('add_extra_convs', False))


# what CARAFE takes from its ``upsample_cfg`` in the JAX package: its
# ``up_kernel``, ``encoder_kernel`` and ``compressed_channels`` in the FPN,
# nothing in the mask head (the defaults, here); the other keys at these
# values or refused
CARAFE_DEFAULTS = dict(up_kernel=5, encoder_kernel=3, compressed_channels=64)
CARAFE_FIXED = dict(type='carafe', up_group=1, encoder_dilation=1,
                    scale_factor=2)


def build_fpn_carafe(cfg: dict) -> FPN_CARAFE:
    """``FPN_CARAFE`` as the JAX builder reads it (``builder.py:178-188``):
    no norm and no activation, a CARAFE upsampler with the config's
    kernels."""
    _check_keys('FPN_CARAFE', cfg, (
        'type', 'in_channels', 'out_channels', 'num_outs', 'start_level',
        'upsample_cfg', 'order'), {'end_level': -1, 'norm_cfg': None,
                                  'act_cfg': None}, DROPPED)
    up = _cfg(cfg.get('upsample_cfg'))
    _check_keys('FPN_CARAFE upsample_cfg', up, tuple(CARAFE_DEFAULTS),
                CARAFE_FIXED, DROPPED)
    return FPN_CARAFE(
        in_channels=tuple(cfg['in_channels']),
        out_channels=cfg.get('out_channels', 256),
        num_outs=cfg.get('num_outs', 5), start_level=cfg.get('start_level', 0),
        **{k: up.get(k, v) for k, v in CARAFE_DEFAULTS.items()})


def _check_coder(what: str, coder: dict) -> None:
    if coder.get('type', 'DeltaXYWHBBoxCoder') != 'DeltaXYWHBBoxCoder':
        raise not_ported(f'{what} {coder["type"]}',
                         LEGACY if 'Legacy' in coder['type'] else 5)
    _check_keys(what, coder, ('type', 'target_means', 'target_stds'),
                {'clip_border': True})


def build_rpn_head(cfg: dict):
    """``RPNHead`` and its anchor and coder configs. Its ``loss_bbox`` is
    L1 whether the config names L1Loss or SmoothL1Loss: JAX's stock RPN
    applies L1 (``dynamask_tpu/models/rpn_head.py:136-140``, ROADMAP.md
    queue 3), and so does the port."""
    cfg = _cfg(cfg)
    t = cfg.get('type')
    if t != 'RPNHead':
        raise not_ported(f'rpn head {t}', 6)
    anchor_cfg = _cfg(cfg.get('anchor_generator'))
    at = anchor_cfg.get('type', 'AnchorGenerator')
    if at != 'AnchorGenerator':
        raise not_ported(f'anchor generator {at}',
                         LEGACY if 'Legacy' in at else 9)
    _check_keys('AnchorGenerator', anchor_cfg,
                ('type', 'scales', 'ratios', 'strides'),
                {'center_offset': 0.0})
    coder = _cfg(cfg.get('bbox_coder'))
    _check_coder('rpn bbox coder', coder)
    loss_cls = _check_loss('rpn loss_cls', cfg.get('loss_cls'),
                           ('CrossEntropyLoss',))
    if not loss_cls.get('use_sigmoid', True):
        raise not_ported('a softmax RPN loss_cls', 'no item')
    _check_loss('rpn loss_bbox', cfg.get('loss_bbox'),
                ('L1Loss', 'SmoothL1Loss'))
    _check_keys('RPNHead', cfg, ('type', 'in_channels', 'feat_channels',
                                 'anchor_generator', 'bbox_coder',
                                 'loss_cls', 'loss_bbox'))
    num_anchors = (len(anchor_cfg.get('scales', [8])) *
                   len(anchor_cfg.get('ratios', [0.5, 1.0, 2.0])))
    head = RPNHead(cfg.get('in_channels', 256), cfg.get('feat_channels', 256),
                   num_anchors)
    return head, anchor_cfg, coder


def _gn_groups(what: str, norm_cfg) -> Optional[int]:
    """A head's ``norm_cfg``: None, or GN's ``num_groups``."""
    norm_cfg = _cfg(norm_cfg)
    if not norm_cfg:
        return None
    if norm_cfg.get('type') != 'GN':
        raise not_ported(f'{what} norm_cfg {norm_cfg.get("type")}',
                         UNQUEUED)
    _check_keys(f'{what} norm_cfg', norm_cfg, ('type', 'num_groups'),
                {'requires_grad': True}, DROPPED)
    return norm_cfg.get('num_groups', 32)


def build_fcn_mask_head(mhc: dict) -> FCNMaskHead:
    """``FCNMaskHead`` from its config (JAX ``builder.py:366-379``): GN on
    its convs; a deconv, or CARAFE at JAX's fixed settings."""
    up = _cfg(mhc.get('upsample_cfg'))
    if up.get('type', 'deconv') == 'carafe':
        _check_keys('FCNMaskHead upsample_cfg', up, (), dict(
            CARAFE_DEFAULTS, **CARAFE_FIXED), DROPPED)
    else:
        _check_keys('FCNMaskHead upsample_cfg', up, (),
                    dict(type='deconv', scale_factor=2), DROPPED)
    groups = _gn_groups('FCNMaskHead', mhc.get('norm_cfg'))
    return FCNMaskHead(
        num_convs=mhc.get('num_convs', 4),
        in_channels=mhc.get('in_channels', 256),
        conv_out_channels=mhc.get('conv_out_channels', 256),
        num_classes=mhc.get('num_classes', 80),
        class_agnostic=mhc.get('class_agnostic', False),
        upsample_type=up.get('type', 'deconv'),
        norm=None if groups is None else 'gn', gn_groups=groups or 32)


def build_dynamask_roi_head(cfg: dict, mhc: dict, common: dict,
                            rcnn_train: dict) -> DynaMaskRoIHead:
    """``DynaMaskRoIHead`` + ``DynaMaskHead`` + the MSM (JAX
    ``dynamask_roi_head.py:422-464``)."""
    loss_cfg = _cfg(mhc.get('loss_cfg'))
    stage_sup_size = tuple(mhc.get('stage_sup_size', (14, 28, 56, 112)))
    mask_head = DynaMaskHead(
        num_convs_instance=mhc.get('num_convs_instance', 2),
        conv_out_channels_instance=mhc.get('conv_out_channels_instance', 256),
        conv_out_channels_semantic=mhc.get('conv_out_channels_semantic', 256),
        semantic_out_stride=tuple(mhc.get('semantic_out_stride', (16, 8, 4))),
        stage_num_classes=tuple(mhc.get('stage_num_classes',
                                        (80, 80, 80, 1))),
        stage_sup_size=stage_sup_size,
        pre_upsample_last_stage=mhc.get('pre_upsample_last_stage', False),
        faithful_stride_quirk=mhc.get('faithful_stride_quirk', True),
        dcn_window=mhc.get('dcn_window', 3))
    # MaskPre fan-in = pyramid channels (semantic extractor if given, else
    # the box extractor's out_channels)
    msm_in = (_cfg(cfg.get('semantic_roi_extractor')).get('out_channels')
              or _cfg(cfg.get('bbox_roi_extractor')).get('out_channels', 256))
    return DynaMaskRoIHead(
        mask_head=mask_head,
        mask_predictor=MaskPre(num_choices=len(stage_sup_size),
                               in_channels=msm_in),
        dynamic_inference=cfg.get('dynamic_inference', False),
        dynamic_capacity=tuple(cfg.get('dynamic_capacity',
                                       (0.5, 0.25, 0.125))),
        stage_sup_size=stage_sup_size,
        stage_detail_loss_weight=tuple(
            loss_cfg.get('stage_detail_loss_weight', (0.5,) * 4)),
        # the faithful last-stage-only instance BCE unless the config turns
        # on the all-stage sum it declares
        stage_instance_loss_weight=(
            tuple(loss_cfg.get('stage_instance_loss_weight',
                               (0.5, 0.75, 0.75, 1.0)))
            if loss_cfg.get('all_stage_instance_loss', False) else None),
        cb_loss_weight=loss_cfg.get('cb_loss_weight', 0.8),
        start_stage=loss_cfg.get('start_stage', 4),
        flops_cost=tuple(rcnn_train.get('flops', (0.23, 0.62, 1.01, 1.4))),
        flops_lambda=rcnn_train.get('Lambda', 0.3),
        **common)


REFINE_HEADS = {'RefineRoIHead': RefineRoIHead,
                'SimpleRefineRoIHead': SimpleRefineRoIHead}
REFINE_MASK_HEADS = {'RefineMaskHead': RefineMaskHead,
                     'SimpleRefineMaskHead': SimpleRefineMaskHead}


def build_refine_roi_head(t: str, mt: str, mhc: dict, common: dict,
                          in_channels: int):
    """``RefineRoIHead`` / ``SimpleRefineRoIHead`` over a
    ``RefineMaskHead`` / ``SimpleRefineMaskHead``, with the JAX builder's
    defaults (``dynamask_tpu/models/builder.py:451-494``). The towers' input
    channels are the pyramid's, ``in_channels``, which the JAX modules
    infer from their input."""
    loss_cfg = _cfg(mhc.get('loss_cfg'))
    stage_sup_size = tuple(mhc.get('stage_sup_size', (14, 28, 56, 112)))
    kw = dict(
        num_convs_instance=mhc.get('num_convs_instance', 2),
        num_convs_semantic=mhc.get('num_convs_semantic', 4),
        conv_in_channels_instance=in_channels,
        conv_in_channels_semantic=in_channels,
        conv_out_channels_instance=mhc.get('conv_out_channels_instance', 256),
        conv_out_channels_semantic=mhc.get('conv_out_channels_semantic', 256),
        semantic_out_stride=mhc.get('semantic_out_stride', 4),
        dilations=tuple(mhc.get('dilations', (1, 3, 5))),
        stage_num_classes=tuple(mhc.get('stage_num_classes',
                                        (80, 80, 80, 80))),
        stage_sup_size=stage_sup_size)
    if mt == 'SimpleRefineMaskHead':
        mask_head = SimpleRefineMaskHead(
            fusion_type=mhc.get('fusion_type', 'MultiBranchFusionAvg'),
            pre_upsample_last_stage=mhc.get('pre_upsample_last_stage', False),
            **kw)
    else:
        mask_head = RefineMaskHead(
            fusion_type=mhc.get('fusion_type', 'MultiBranchFusion'),
            mask_use_sigmoid=mhc.get('mask_use_sigmoid', False), **kw)
    return REFINE_HEADS[t](
        mask_head=mask_head, stage_sup_size=stage_sup_size,
        stage_instance_loss_weight=tuple(loss_cfg.get(
            'stage_instance_loss_weight', (0.25, 0.5, 0.75, 1.0))),
        semantic_loss_weight=loss_cfg.get('semantic_loss_weight', 1.0),
        boundary_width=loss_cfg.get('boundary_width', 2),
        start_stage=loss_cfg.get('start_stage', 1), **common)


CASCADE_HEADS = ('CascadeRoIHead', 'HybridTaskCascadeRoIHead')
ROI_HEADS = ('StandardRoIHead', 'DynaMaskRoIHead', 'DoubleHeadRoIHead',
             *REFINE_HEADS, *CASCADE_HEADS, 'MaskScoringRoIHead',
             'PointRendRoIHead', 'PointRefineRoIHead', 'GridRoIHead',
             'DynamicRoIHead', 'PISARoIHead')
# the typed RoI samplers (Libra's, PISA's) and the heads that take them
TYPED_SAMPLERS = {'StandardRoIHead': ('CombinedSampler',),
                  'PISARoIHead': ('ScoreHLRSampler',)}


# DeformRoIPool's layer types (JAX ``builder.py:341-344``) and the keys
# JAX reads of them
DEFORM_POOLS = ('DeformRoIPoolPack', 'ModulatedDeformRoIPoolPack',
                'DeformRoIPoolingPack', 'ModulatedDeformRoIPoolingPack')
DEFORM_POOL_KEYS = ('type', 'output_size', 'output_channels', 'trans_std',
                    'sample_per_part')


def _extractor(cfg: dict, what: str, deform: bool = False) -> dict:
    """A ``SingleRoIExtractor`` over ``RoIAlign`` (mmcv ``aligned=True``;
    the JAX package's static ``sampling_ratio`` 2 whatever the config's),
    or GRoIE's ``GenericRoIExtractor`` with its ``aggregation`` over the
    same (its ``pre_cfg`` / ``post_cfg`` modules, which JAX drops,
    refused), or with ``deform`` a ``SingleRoIExtractor`` over a
    DeformRoIPool layer (its ``output_channels`` the extractor's
    ``out_channels``: JAX's offset branch reads the pyramid's width);
    refused otherwise."""
    cfg = _cfg(cfg)
    t = cfg.get('type', 'SingleRoIExtractor')
    if t not in ('SingleRoIExtractor', 'GenericRoIExtractor'):
        raise not_ported(f'{what} {t}', UNQUEUED)
    layer = _cfg(cfg.get('roi_layer'))
    lt = layer.get('type', 'RoIAlign')
    if deform and lt in DEFORM_POOLS and t == 'SingleRoIExtractor':
        _check_keys(f'{what} {lt}', layer, DEFORM_POOL_KEYS, item=DROPPED)
        if layer.get('output_channels', cfg.get('out_channels', 256)) != \
                cfg.get('out_channels', 256):
            raise not_ported(f'{what} {lt} output_channels other than the '
                             'pyramid\'s', DROPPED)
    elif lt != 'RoIAlign':
        raise not_ported(f'{what} roi_layer {lt}', UNQUEUED)
    else:
        if not layer.get('aligned', True):
            raise not_ported(f'{what} RoIAlign aligned=False', LEGACY)
        _check_keys(f'{what} roi_layer', layer, ('type', 'output_size',
                                                 'sampling_ratio',
                                                 'aligned'))
    if t == 'GenericRoIExtractor':
        _check_keys(f'{what} GenericRoIExtractor', cfg, (
            'type', 'roi_layer', 'out_channels', 'featmap_strides',
            'aggregation'), item=DROPPED)
    else:
        _check_keys(what, cfg, ('type', 'roi_layer', 'out_channels',
                                'featmap_strides'), {'finest_scale': 56})
    return cfg


def build_deform_roi_pool(extractor: dict):
    """The DeformRoIPool configs' box extractor (JAX ``builder.py:
    341-351``), or None over RoIAlign."""
    layer = _cfg(extractor.get('roi_layer'))
    if layer.get('type') not in DEFORM_POOLS:
        return None
    from .deform_roi_pool import DeformRoIPoolPack
    return DeformRoIPoolPack(
        in_channels=extractor.get('out_channels', 256),
        out_size=layer.get('output_size', 7),
        featmap_strides=tuple(extractor.get('featmap_strides',
                                            (4, 8, 16, 32))),
        trans_std=layer.get('trans_std', 0.1),
        sample_per_part=layer.get('sample_per_part', 4),
        modulated=layer['type'].startswith('Modulated'))


# the ResLayer shared head's keys (JAX ``builder.py:355-361``, shared_head.
# py:20-28); its norm_cfg popped, taken at BN (3j: the affine trains)
SHARED_HEAD_KEYS = ('type', 'depth', 'stage', 'stride', 'dilation', 'style',
                    'norm_eval')


def build_shared_head(cfg: dict, in_channels: int):
    """The C4 configs' ``ResLayer`` shared head."""
    from .shared_head import ResLayerSharedHead
    cfg = _cfg(cfg)
    cfg.pop('pretrained', None)
    if cfg.get('type') != 'ResLayer':
        raise not_ported(f'shared head {cfg.get("type")}', UNQUEUED)
    norm = _cfg(cfg.pop('norm_cfg', None))
    if norm.get('type', 'BN') != 'BN':
        raise not_ported(f'ResLayer norm_cfg {norm}', DROPPED)
    _check_keys('ResLayer', cfg, SHARED_HEAD_KEYS, item=DROPPED)
    return ResLayerSharedHead(in_channels, **{k: v for k, v in cfg.items()
                                              if k != 'type'})


def _extract_mode(bbox_extractor: dict, mask_extractor: dict) -> str:
    """The RoI head's ``roi_extract_mode``: the box extractor's, which JAX
    applies to the mask extract too (``builder.py:334-338``,
    ``roi_head.py:192``); a mask extractor of another type is refused
    (3z)."""
    bt = bbox_extractor.get('type', 'SingleRoIExtractor')
    if mask_extractor and mask_extractor.get(
            'type', 'SingleRoIExtractor') != bt:
        raise not_ported('a mask extractor of another type than the box '
                         'extractor\'s', 'ROADMAP.md queue 3, 3z: the JAX '
                         'package extracts both as the box extractor')
    if bt != 'GenericRoIExtractor':
        return 'single'
    aggregation = bbox_extractor.get('aggregation', 'sum')
    if mask_extractor and mask_extractor.get('aggregation',
                                             'sum') != aggregation:
        raise not_ported('a mask extractor of another aggregation than the '
                         'box extractor\'s', 'ROADMAP.md queue 3, 3z: the '
                         'JAX package extracts both as the box extractor')
    return f'generic_{aggregation}'


# the regression losses by ``loss_bbox.type``, with the keys each reads
# beside ``loss_weight`` at the values JAX computes with (it reads none,
# 3w): mmdet's IoU losses take eps 1e-6, JAX's 1e-7
REG_LOSSES = {'L1Loss': (None, {}), 'SmoothL1Loss': (None, {}),
              'IoULoss': ('iou', {'linear': False}), 'GIoULoss': ('giou', {}),
              'BoundedIoULoss': ('bounded_iou', {'beta': 0.2, 'eps': 1e-3}),
              'BalancedL1Loss': ('balanced_l1', {'alpha': 0.5,
                                                 'gamma': 1.5})}


def _box_losses(head_cfg: dict) -> dict:
    """The box head's loss weights and regression loss: L1, SmoothL1 or
    Libra's balanced L1 with its ``beta`` (JAX ``builder.py:322-327``),
    or an IoU loss."""
    _check_loss('bbox head loss_cls', head_cfg.get('loss_cls'),
                ('CrossEntropyLoss',))
    if _cfg(head_cfg.get('loss_cls')).get('use_sigmoid', False):
        raise not_ported('a sigmoid bbox head loss_cls', 5)
    loss_bbox = _cfg(head_cfg.get('loss_bbox'))
    lt = loss_bbox.get('type', 'L1Loss')
    if lt not in REG_LOSSES:
        raise not_ported(f'bbox head loss_bbox {lt}', 'no item')
    kind, fixed = REG_LOSSES[lt]
    if kind:
        # Libra's balanced L1 reads its beta; alpha and gamma are fixed
        _check_keys(f'bbox head {lt}', loss_bbox, ('type', 'loss_weight') +
                    (('beta',) if kind == 'balanced_l1' else ()), fixed,
                    DROPPED)
    return dict(
        loss_cls_weight=_cfg(head_cfg.get('loss_cls')).get('loss_weight',
                                                            1.0),
        loss_bbox_weight=loss_bbox.get('loss_weight', 1.0),
        smooth_l1_beta=(loss_bbox.get('beta', 1.0)
                        if lt in ('SmoothL1Loss', 'BalancedL1Loss')
                        else None),
        reg_loss_type=kind,
        reg_decoded_bbox=bool(head_cfg.get('reg_decoded_bbox', False)))


BOX_HEADS = {'Shared2FCBBoxHead': Shared2FCBBoxHead,
             'Shared4Conv1FCBBoxHead': Shared4Conv1FCBBoxHead,
             'ConvFCBBoxHead': ConvFCBBoxHead}
# the C4 head's fixed keys (JAX ``bbox_head.py:92-98``: no conv, no fc, the
# average pool)
PLAIN_BOX_HEAD = dict(with_avg_pool=True, with_cls=True)
BOX_HEAD_KEYS = ('num_classes', 'in_channels', 'roi_feat_size',
                 'fc_out_channels', 'reg_class_agnostic', 'reg_decoded_bbox',
                 'bbox_coder', 'loss_cls', 'loss_bbox')
DOUBLE_HEAD_KEYS = ('num_convs', 'num_fcs', 'conv_out_channels')


def _box_head(head_cfg: dict, with_reg: bool = True):
    """A ``ConvFCBBoxHead`` (``Shared2FCBBoxHead``, or
    ``Shared4Conv1FCBBoxHead`` with GN on its convs; class-specific or
    class-agnostic regression) or Double-Head's ``DoubleConvFCBBoxHead``
    -> (head, its coder, its config). JAX's builder passes a
    ``ConvFCBBoxHead`` no conv or fc counts (its defaults, 0 and 2) and
    no ``conv_out_channels`` (the convs emit ``in_channels``): other
    values are refused (3w). The head regresses with ``with_reg`` and
    classifies only without (Grid R-CNN's, JAX ``with_reg=False``); a
    config that says otherwise is refused."""
    head_cfg = _cfg(head_cfg)
    ht = head_cfg.pop('type')
    if head_cfg.pop('with_reg', True) != with_reg:
        raise not_ported(f'{ht} with_reg={not with_reg} (JAX regresses in '
                         'every box head but Grid R-CNN\'s, which has '
                         'none)', DROPPED)
    common = dict(num_classes=head_cfg.get('num_classes', 80),
                  in_channels=head_cfg.get('in_channels', 256),
                  roi_feat_size=head_cfg.get('roi_feat_size', 7),
                  fc_out_channels=head_cfg.get('fc_out_channels', 1024),
                  reg_class_agnostic=bool(head_cfg.get('reg_class_agnostic',
                                                       False)))
    if ht == 'DoubleConvFCBBoxHead':
        _check_keys(ht, head_cfg, BOX_HEAD_KEYS + DOUBLE_HEAD_KEYS,
                    item=DROPPED)
        head = DoubleConvFCBBoxHead(
            num_convs=head_cfg.get('num_convs', 4),
            num_fcs=head_cfg.get('num_fcs', 2),
            conv_out_channels=head_cfg.get('conv_out_channels', 1024),
            **common)
    elif ht == 'BBoxHead':
        _check_keys(ht, head_cfg, BOX_HEAD_KEYS, PLAIN_BOX_HEAD, DROPPED)
        head = BBoxHead(with_reg=with_reg, **common)
    elif ht in BOX_HEADS:
        _check_keys(ht, head_cfg, BOX_HEAD_KEYS + ('norm_cfg',), dict(
            conv_out_channels=common['in_channels'], num_shared_convs=0,
            num_shared_fcs=2, num_cls_convs=0, num_cls_fcs=0,
            num_reg_convs=0, num_reg_fcs=0, with_cls=True),
            DROPPED)
        groups = _gn_groups(ht, head_cfg.get('norm_cfg'))
        head = BOX_HEADS[ht](norm=None if groups is None else 'gn',
                             gn_groups=groups or 32, with_reg=with_reg,
                             **common)
    else:
        raise not_ported(f'bbox head {ht}', 'no item')
    coder = _cfg(head_cfg.get('bbox_coder'))
    _check_coder('bbox head coder', coder)
    return head, coder, head_cfg


def build_roi_head(cfg: dict, train_cfg: dict, test_cfg: dict):
    """The RoI head of ``cfg``: ``StandardRoIHead`` with an
    ``FCNMaskHead`` (Mask R-CNN) or with none (Faster and Fast R-CNN),
    ``DynaMaskRoIHead`` with a ``DynaMaskHead`` (DynaMask),
    ``RefineRoIHead`` / ``SimpleRefineRoIHead`` with a ``RefineMaskHead``
    / ``SimpleRefineMaskHead`` (RefineMask), on one conv/fc box branch;
    ``DoubleHeadRoIHead`` over a ``DoubleConvFCBBoxHead`` (Double-Head);
    ``CascadeRoIHead`` (Cascade R-CNN, with an ``FCNMaskHead`` or none)
    and ``HybridTaskCascadeRoIHead`` (HTC) on one a stage;
    ``MaskScoringRoIHead``, ``PointRendRoIHead``, ``PointRefineRoIHead``,
    ``GridRoIHead`` and ``DynamicRoIHead``. The extract
    (FPN-routed or GRoIE's), the regression loss, the test NMS and the
    sampler's ``num`` / ``pos_fraction`` are the configs'."""
    cfg = _cfg(cfg)
    t = cfg.pop('type')
    if t not in ROI_HEADS:
        raise not_ported(f'roi head {t}', 'no item')
    cascade = t in CASCADE_HEADS
    stage_cfgs = cfg['bbox_head']
    if isinstance(stage_cfgs, (list, tuple)) != cascade:
        raise not_ported(f'{t} over {type(stage_cfgs).__name__} bbox_head',
                         'no item')
    stages = [_box_head(h, with_reg=t != 'GridRoIHead')
              for h in (stage_cfgs if cascade else [stage_cfgs])]
    bbox_head, coder, head_cfg = stages[0]
    rcnn_raw = _cfg(train_cfg).get('rcnn')
    if cascade and rcnn_raw is not None:
        stage_train = [_cfg(r) for r in rcnn_raw]
    else:
        stage_train = [_cfg(rcnn_raw)]
    rcnn_train = stage_train[0]
    assigner = _cfg(rcnn_train.get('assigner'))
    sampler = _cfg(rcnn_train.get('sampler'))
    # OHEM as JAX runs it (ROADMAP.md queue 3, 3s): JAX's OHEMSampler ranks
    # by ``cand_losses``, which no caller passes, and otherwise draws as
    # RandomSampler, so the head's RandomSampler with the config's ``num``
    # / ``pos_fraction`` is its draw; mmdet keeps the hardest candidates
    for i, st in enumerate(stage_train):
        _check_sampling(f'rcnn {i}' if cascade else 'rcnn',
                        _cfg(st.get('assigner')), _cfg(st.get('sampler')),
                        ('RandomSampler', 'OHEMSampler') +
                        TYPED_SAMPLERS.get(t, ()), ('ScoreHLRSampler',))
    bbox_extractor = _extractor(cfg.get('bbox_roi_extractor'),
                                'bbox_roi_extractor', deform=True)
    # the C4 shared head and the DeformRoIPool extractor, under
    # StandardRoIHead, the one head of the configs that name them
    roi_parts = {}
    if cfg.get('shared_head'):
        roi_parts['shared_head'] = build_shared_head(
            cfg['shared_head'], bbox_extractor.get('out_channels', 256))
    deform_pool = build_deform_roi_pool(bbox_extractor)
    if deform_pool is not None:
        roi_parts['bbox_roi_extractor'] = deform_pool
    if roi_parts and t != 'StandardRoIHead':
        raise not_ported(f'{sorted(roi_parts)} under {t}', UNQUEUED)
    point_rend = t == 'PointRendRoIHead'
    mask_extractor = (_point_rend_extractor if point_rend else _extractor)(
        cfg.get('mask_roi_extractor'), 'mask_roi_extractor')
    rcnn_test = _cfg(_cfg(test_cfg).get('rcnn'))
    nms_cfg = _cfg(rcnn_test.get('nms'))
    common = dict(
        num_classes=head_cfg.get('num_classes', 80),
        featmap_strides=tuple(bbox_extractor.get('featmap_strides',
                                                 (4, 8, 16, 32))),
        bbox_roi_out=_cfg(bbox_extractor.get('roi_layer')).get(
            'output_size', 7),
        mask_roi_out=_cfg(mask_extractor.get('roi_layer')).get(
            'output_size', 14),
        target_means=tuple(coder.get('target_means', (0., 0., 0., 0.))),
        target_stds=tuple(coder.get('target_stds', (0.1, 0.1, 0.2, 0.2))),
        score_thr=rcnn_test.get('score_thr', 0.05),
        nms_iou_thr=nms_cfg.get('iou_threshold', 0.5),
        max_per_img=rcnn_test.get('max_per_img', 100),
        num_samples=sampler.get('num', 512),
        pos_fraction=sampler.get('pos_fraction', 0.25),
        max_pos=int(sampler.get('num', 512) *
                    sampler.get('pos_fraction', 0.25)),
        add_gt_as_proposals=sampler.get('add_gt_as_proposals', True),
        pos_iou_thr=assigner.get('pos_iou_thr', 0.5),
        neg_iou_thr=assigner.get('neg_iou_thr', 0.5),
        min_pos_iou=assigner.get('min_pos_iou', 0.5),
        match_low_quality=assigner.get('match_low_quality', True),
        roi_extract_mode=_extract_mode(bbox_extractor,
                                       {} if point_rend else mask_extractor),
        nms_cfg=_test_nms(nms_cfg),
        **_box_losses(head_cfg))
    if sampler.get('type') in ('CombinedSampler', 'ScoreHLRSampler'):
        common['sampler'] = build_sampler(sampler)
    if (t == 'DoubleHeadRoIHead') != any(
            isinstance(h, DoubleConvFCBBoxHead) for h, _, _ in stages):
        raise not_ported(f'{t} over {type(bbox_head).__name__} (the '
                         'Double-Head pair goes together)', UNQUEUED)
    if cascade:
        return build_cascade_roi_head(t, cfg, stages, stage_train, common,
                                      bbox_extractor)
    mhc = _cfg(cfg.get('mask_head'))
    mt = mhc.pop('type', None)
    common['bbox_head'] = bbox_head
    if t in ROI_HEAD_KEYS:
        _check_keys(t, cfg, ROI_HEAD_KEYS[t], {'mask_head': None,
                                               'mask_roi_extractor': None,
                                               'shared_head': None},
                    DROPPED)
    in_channels = mask_extractor.get('out_channels', 256)
    if t == 'MaskScoringRoIHead':
        return build_mask_scoring_roi_head(cfg, mhc, mt, common, rcnn_train,
                                           in_channels)
    if t == 'PointRendRoIHead':
        return build_point_rend_roi_head(cfg, mhc, mt, common, rcnn_train,
                                         rcnn_test, in_channels)
    if t == 'PointRefineRoIHead':
        return build_point_refine_roi_head(mhc, mt, common, in_channels)
    if t == 'GridRoIHead':
        return build_grid_roi_head(cfg, common, rcnn_train, bbox_extractor)
    if t == 'DynamicRoIHead':
        return build_dynamic_roi_head(cfg, common, rcnn_train)
    if t == 'PISARoIHead':
        return build_pisa_roi_head(cfg, mhc, mt, common, rcnn_train,
                                   head_cfg)
    if t == 'DoubleHeadRoIHead' and mt is None:
        _check_keys(t, cfg, ('reg_roi_scale_factor', 'bbox_head',
                             'bbox_roi_extractor'),
                    {'mask_head': None, 'mask_roi_extractor': None},
                    DROPPED)
        return DoubleHeadRoIHead(reg_roi_scale_factor=cfg.get(
            'reg_roi_scale_factor', 1.3), mask_head=None, **common)
    if t == 'StandardRoIHead' and mt is None:
        return StandardRoIHead(mask_head=None, **common, **roi_parts)
    if (t, mt) == ('DynaMaskRoIHead', 'DynaMaskHead'):
        return build_dynamask_roi_head(cfg, mhc, common, rcnn_train)
    if (t, mt) == ('StandardRoIHead', 'FCNMaskHead'):
        return StandardRoIHead(
            mask_head=build_fcn_mask_head(mhc), loss_mask_weight=_cfg(
                mhc.get('loss_mask')).get('loss_weight', 1.0), **common,
            **roi_parts)
    if t in REFINE_HEADS and mt in REFINE_MASK_HEADS:
        return build_refine_roi_head(t, mt, mhc, common, in_channels)
    raise not_ported(
        f'mask head {mt} under {t} (the port has none or FCNMaskHead under '
        'StandardRoIHead, DynaMaskHead under DynaMaskRoIHead, and '
        'RefineMaskHead or SimpleRefineMaskHead under RefineRoIHead or '
        'SimpleRefineRoIHead)', UNQUEUED)


def build_sampler(sampler: dict):
    """Libra's ``CombinedSampler`` over an ``InstanceBalancedPosSampler``
    and an ``IoUBalancedNegSampler`` (JAX reads ``floor_thr`` and
    ``num_bins``; ``floor_fraction`` only at 0), or PISA's
    ``ScoreHLRSampler`` (every key read), built as JAX's registry builds
    them (``samplers.py:265-297``, ``pisa.py:224-233``)."""
    from ..core.samplers import (CombinedSampler, InstanceBalancedPosSampler,
                                 IoUBalancedNegSampler)
    from .pisa import ScoreHLRSampler
    t = sampler['type']
    common = dict(num=sampler.get('num', 512),
                  pos_fraction=sampler.get('pos_fraction', 0.25),
                  neg_pos_ub=sampler.get('neg_pos_ub', -1))
    if t == 'ScoreHLRSampler':
        _check_keys(t, sampler, ('type', 'num', 'pos_fraction', 'neg_pos_ub',
                                 'add_gt_as_proposals', 'k', 'bias',
                                 'score_thr', 'iou_thr'), item=DROPPED)
        return ScoreHLRSampler(k=sampler.get('k', 0.5),
                               bias=sampler.get('bias', 0.0),
                               score_thr=sampler.get('score_thr', 0.05),
                               iou_thr=sampler.get('iou_thr', 0.5), **common)
    _check_keys(t, sampler, ('type', 'num', 'pos_fraction', 'neg_pos_ub',
                             'add_gt_as_proposals', 'pos_sampler',
                             'neg_sampler'), item=DROPPED)
    pos, neg = _cfg(sampler.get('pos_sampler')), _cfg(
        sampler.get('neg_sampler'))
    if (pos.get('type'), neg.get('type')) != ('InstanceBalancedPosSampler',
                                              'IoUBalancedNegSampler'):
        raise not_ported(f'CombinedSampler over {pos.get("type")} and '
                         f'{neg.get("type")} (the port has Libra\'s pair)',
                         'no item')
    _check_keys('InstanceBalancedPosSampler', pos, ('type',), item=DROPPED)
    _check_keys('IoUBalancedNegSampler', neg, ('type', 'floor_thr',
                                               'num_bins'),
                {'floor_fraction': 0}, DROPPED)
    return CombinedSampler(
        pos_sampler=InstanceBalancedPosSampler(**common),
        neg_sampler=IoUBalancedNegSampler(
            floor_thr=neg.get('floor_thr', -1),
            num_bins=neg.get('num_bins', 3), **common), **common)


def pisa_cfg(train_cfg: dict) -> dict:
    """PISA's ``isr`` and ``carl`` of a ``train_cfg`` (their ``k`` and
    ``bias``) as the keyword arguments of its heads."""
    isr, carl = _cfg(train_cfg.get('isr')), _cfg(train_cfg.get('carl'))
    _check_keys('PISA isr', isr, ('k', 'bias'), item=DROPPED)
    _check_keys('PISA carl', carl, ('k', 'bias'), item=DROPPED)
    return dict(isr_k=isr.get('k', 2.0), isr_bias=isr.get('bias', 0.0),
                carl_k=carl.get('k', 1.0), carl_bias=carl.get('bias', 0.2))


def build_pisa_roi_head(cfg: dict, mhc: dict, mt, common: dict,
                        rcnn_train: dict, head_cfg: dict):
    """``PISARoIHead`` (JAX ``builder.py:389-420``) over its
    ``ScoreHLRSampler``: Mask R-CNN's FCN mask head or none,
    ``train_cfg.rcnn``'s ``isr`` and ``carl``; its box loss
    is SmoothL1 of the head's ``beta`` whatever the type, so only a
    ``SmoothL1Loss`` is taken."""
    from .pisa import PISARoIHead, ScoreHLRSampler
    _check_keys('PISARoIHead', cfg, ('bbox_roi_extractor', 'bbox_head',
                                     'mask_roi_extractor', 'mask_head'),
                item=DROPPED)
    if not isinstance(common.get('sampler'), ScoreHLRSampler):
        raise not_ported('PISARoIHead without a ScoreHLRSampler (no config '
                         'names one)', 'no item')
    lt = _cfg(head_cfg.get('loss_bbox')).get('type', 'L1Loss')
    if lt != 'SmoothL1Loss':
        raise not_ported(f'PISARoIHead loss_bbox {lt} (JAX applies '
                         'SmoothL1)', DROPPED)
    kw = pisa_cfg(rcnn_train)
    if mt is None:
        return PISARoIHead(mask_head=None, **kw, **common)
    if mt != 'FCNMaskHead':
        raise not_ported(f'{mt} under PISARoIHead (JAX builds an '
                         'FCNMaskHead)', DROPPED)
    return PISARoIHead(mask_head=build_fcn_mask_head(mhc),
                       loss_mask_weight=_cfg(mhc.get('loss_mask')).get(
                           'loss_weight', 1.0), **kw, **common)


MASK_LOSS = dict(type='CrossEntropyLoss', use_mask=True)
# the keys of Mask Scoring R-CNN's, PointRend's, PointRefine's, Grid R-CNN's
# and Dynamic R-CNN's RoI head configs beside ``type`` (JAX reads these)
ROI_HEAD_KEYS = {
    'MaskScoringRoIHead': ('bbox_roi_extractor', 'bbox_head',
                           'mask_roi_extractor', 'mask_head',
                           'mask_iou_head'),
    'PointRendRoIHead': ('bbox_roi_extractor', 'bbox_head',
                         'mask_roi_extractor', 'mask_head', 'point_head'),
    'PointRefineRoIHead': ('bbox_roi_extractor', 'bbox_head',
                           'mask_roi_extractor', 'mask_head'),
    'GridRoIHead': ('bbox_roi_extractor', 'bbox_head', 'grid_roi_extractor',
                    'grid_head'),
    'DynamicRoIHead': ('bbox_roi_extractor', 'bbox_head'),
}
# what JAX's ``MaskIoUHead`` computes with, whatever the config says
MASK_IOU_FIXED = dict(num_convs=4, num_fcs=2, conv_out_channels=256,
                      fc_out_channels=1024)
# Grid R-CNN's grid loss, its weight fixed in JAX (``grid_rcnn.py:338``)
GRID_LOSS = dict(type='CrossEntropyLoss', use_sigmoid=True,
                 loss_weight=GRID_LOSS_WEIGHT)
# every grid file's ``max_num_grid``, which JAX does not apply (3ay)
MAX_NUM_GRID = 192


def _point_rend_extractor(cfg: dict, what: str) -> dict:
    """PointRend's mask extractor: its one level, stride 4 (JAX reads its
    ``output_size`` and crops P2 with RoIAlign at ratio 1, 3ba). The
    files' ``roi_layer`` keeps the base config's ``sampling_ratio`` 0
    through the merge, which ``SimpleRoIAlign`` has no use for."""
    cfg = _cfg(cfg)
    layer = _cfg(cfg.get('roi_layer'))
    _check_keys(f'{what} roi_layer', layer, ('output_size',),
                {'type': 'SimpleRoIAlign', 'sampling_ratio': 0}, DROPPED)
    _check_keys(what, cfg, ('roi_layer', 'out_channels'), dict(
        type='GenericRoIExtractor', aggregation='concat',
        featmap_strides=[4]), DROPPED)
    return cfg


def _mask_loss_weight(mhc: dict) -> float:
    loss = _cfg(mhc.get('loss_mask'))
    _check_keys('loss_mask', loss, ('loss_weight',), MASK_LOSS, DROPPED)
    return loss.get('loss_weight', 1.0)


def build_mask_scoring_roi_head(cfg: dict, mhc: dict, mt, common: dict,
                                rcnn_train: dict, in_channels: int):
    """Mask R-CNN's FCN mask head and the ``MaskIoUHead`` JAX builds (its
    defaults, the RoI head's classes); the IoU loss's weight."""
    if mt != 'FCNMaskHead':
        raise not_ported(f'{mt} under MaskScoringRoIHead (JAX builds an '
                         'FCNMaskHead)', DROPPED)
    ic = _cfg(cfg.get('mask_iou_head'))
    loss = _cfg(ic.get('loss_iou'))
    _check_keys('loss_iou', loss, ('loss_weight',), {'type': 'MSELoss'},
                DROPPED)
    _check_keys('MaskIoUHead', ic, ('loss_iou',), dict(
        MASK_IOU_FIXED, type='MaskIoUHead', in_channels=in_channels,
        roi_feat_size=common['mask_roi_out'],
        num_classes=common['num_classes']), DROPPED)
    if rcnn_train.get('mask_thr_binary', 0.5) != 0.5:
        raise not_ported('train_cfg.rcnn.mask_thr_binary other than the '
                         '0.5 JAX binarises at', DROPPED)
    return MaskScoringRoIHead(
        mask_head=build_fcn_mask_head(mhc),
        mask_iou_head=MaskIoUHead(in_channels=in_channels,
                                  roi_feat_size=common['mask_roi_out'],
                                  num_classes=common['num_classes'],
                                  **MASK_IOU_FIXED),
        loss_iou_weight=loss.get('loss_weight', 0.5),
        loss_mask_weight=_mask_loss_weight(mhc), **common)


COARSE_KEYS = ('num_convs', 'num_fcs', 'in_channels', 'conv_out_channels',
               'fc_out_channels', 'downsample_factor', 'roi_feat_size',
               'num_classes', 'loss_mask')
POINT_KEYS = ('num_classes', 'num_fcs', 'in_channels', 'fc_channels',
              'class_agnostic', 'coarse_pred_each_layer', 'loss_point')


def build_point_rend_roi_head(cfg: dict, mhc: dict, mt, common: dict,
                              rcnn_train: dict, rcnn_test: dict,
                              in_channels: int):
    """``CoarseMaskHead`` + ``MaskPointHead`` (JAX ``builder.py:495-527``):
    the point head's loss at weight 1, as JAX applies it; the points'
    features P2's (stride 4, the extractor's only level)."""
    if mt != 'CoarseMaskHead':
        raise not_ported(f'{mt} under PointRendRoIHead', DROPPED)
    _check_keys('CoarseMaskHead', mhc, COARSE_KEYS, item=DROPPED)
    if mhc.get('in_channels', 256) != in_channels or mhc.get(
            'roi_feat_size', 14) != common['mask_roi_out']:
        raise not_ported('a CoarseMaskHead of other input channels or size '
                         "than its P2 crops'", DROPPED)
    coarse = CoarseMaskHead(**{k: mhc[k] for k in COARSE_KEYS[:-1]
                               if k in mhc})
    phc = _cfg(cfg.get('point_head'))
    if phc.pop('type', None) != 'MaskPointHead':
        raise not_ported('a PointRend point head other than MaskPointHead',
                         DROPPED)
    _check_keys('MaskPointHead', phc, POINT_KEYS, item=DROPPED)
    _check_keys('loss_point', _cfg(phc.get('loss_point')), (),
                dict(MASK_LOSS, loss_weight=1.0), DROPPED)
    if phc.get('in_channels', 256) != in_channels or phc.get(
            'num_classes', 80) != coarse.num_classes:
        raise not_ported('a MaskPointHead of other input channels or '
                         'classes than the P2 crops\' and the coarse '
                         'head\'s', DROPPED)
    point = MaskPointHead(**{k: phc[k] for k in POINT_KEYS[:-1] if k in phc})
    if rcnn_train.get('mask_size', coarse.out_size) != coarse.out_size:
        raise not_ported(f'PointRend train_cfg.rcnn.mask_size '
                         f'{rcnn_train["mask_size"]} (JAX trains the coarse '
                         f'head at its {coarse.out_size})', DROPPED)
    return PointRendRoIHead(
        mask_head=coarse, point_head=point,
        num_points=rcnn_train.get('num_points', 196),
        oversample_ratio=rcnn_train.get('oversample_ratio', 3.0),
        importance_sample_ratio=rcnn_train.get('importance_sample_ratio',
                                               0.75),
        subdivision_steps=rcnn_test.get('subdivision_steps', 5),
        subdivision_num_points=rcnn_test.get('subdivision_num_points', 784),
        scale_factor=rcnn_test.get('scale_factor', 2),
        loss_mask_weight=_mask_loss_weight(mhc), **common)


POINT_REFINE_KEYS = ('num_convs_instance', 'num_convs_semantic', 'num_fcs',
                     'conv_out_channels_instance',
                     'conv_out_channels_semantic', 'semantic_out_stride',
                     'mask_use_sigmoid', 'coarse_pred_each_layer',
                     'stage_num_classes', 'stage_sup_size', 'num_points')


def build_point_refine_roi_head(mhc: dict, mt, common: dict,
                                in_channels: int):
    """``PointRefineMaskHead`` (JAX ``builder.py:579-610``). Its loss
    config's ``start_stage`` 4 is the all-plain supervision JAX computes
    (its ``boundary_width`` then reaches nothing); the loss type the
    reference lacks is taken as JAX takes it (``point_refine_head.py:
    10-15``)."""
    if mt != 'PointRefineMaskHead':
        raise not_ported(f'{mt} under PointRefineRoIHead', DROPPED)
    loss_cfg = _cfg(mhc.pop('loss_cfg', None))
    _check_keys('PointRefineMaskHead', mhc, POINT_REFINE_KEYS, item=DROPPED)
    _check_keys('PointRefineMaskHead loss_cfg', loss_cfg, (
        'stage_instance_loss_weight', 'semantic_loss_weight',
        'detail_loss_weight', 'boundary_width'), dict(
            type='PointRefineCrossEntropyLoss', start_stage=4), DROPPED)
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in mhc.items()}
    mask_head = PointRefineMaskHead(conv_in_channels_instance=in_channels,
                                    conv_in_channels_semantic=in_channels,
                                    **kw)
    return PointRefineRoIHead(
        mask_head=mask_head,
        stage_sup_size=tuple(mhc.get('stage_sup_size', (14, 28, 56, 112))),
        stage_instance_loss_weight=tuple(loss_cfg.get(
            'stage_instance_loss_weight', (0.5,) * 4)),
        semantic_loss_weight=loss_cfg.get('semantic_loss_weight', 1.0),
        detail_loss_weight=loss_cfg.get('detail_loss_weight', 1.0),
        boundary_width=loss_cfg.get('boundary_width', 2), start_stage=4,
        **common)


GRID_HEAD_KEYS = ('grid_points', 'num_convs', 'roi_feat_size', 'in_channels',
                  'point_feat_channels', 'norm_cfg', 'loss_grid')


def build_grid_roi_head(cfg: dict, common: dict, rcnn_train: dict,
                        bbox_extractor: dict):
    """``GridHead`` and ``GridRoIHead`` (JAX ``builder.py:421-436``) over
    the box head without regression that ``_box_head`` builds for it. The
    grid extract takes the box extractor's mode whatever the grid
    extractor's type (3z)."""
    gh = _cfg(cfg.get('grid_head'))
    if gh.pop('type', None) != 'GridHead':
        raise not_ported('a grid head other than GridHead', DROPPED)
    _check_keys('GridHead', gh, GRID_HEAD_KEYS, dict(
        conv_kernel_size=3, deconv_kernel_size=4,
        conv_out_channels=gh.get('point_feat_channels', 64) *
        gh.get('grid_points', 9)), DROPPED)
    _check_keys('loss_grid', _cfg(gh.get('loss_grid')), (), GRID_LOSS,
                DROPPED)
    norm = _cfg(gh.get('norm_cfg'))
    _check_keys('GridHead norm_cfg', norm, ('num_groups',),
                {'type': 'GN', 'requires_grad': True}, DROPPED)
    ext = _extractor(cfg.get('grid_roi_extractor'), 'grid_roi_extractor')
    out = _cfg(ext.get('roi_layer')).get('output_size', 14)
    if gh.get('roi_feat_size', 14) != out or gh.get(
            'in_channels', 256) != bbox_extractor.get('out_channels', 256):
        raise not_ported('a GridHead of another roi_feat_size or in_channels '
                         'than its crops\'', DROPPED)
    if rcnn_train.get('max_num_grid', MAX_NUM_GRID) != MAX_NUM_GRID:
        raise not_ported(f'train_cfg.rcnn.max_num_grid other than every '
                         f'file\'s {MAX_NUM_GRID} (JAX applies none, 3ay)',
                         DROPPED)
    head = GridHead(grid_points=gh.get('grid_points', 9),
                    num_convs=gh.get('num_convs', 8), roi_feat_size=out,
                    in_channels=gh.get('in_channels', 256),
                    point_feat_channels=gh.get('point_feat_channels', 64),
                    gn_groups=norm.get('num_groups', 36))
    return GridRoIHead(grid_head=head, grid_roi_out=out,
                       pos_radius=rcnn_train.get('pos_radius', 1), **common)


DYNAMIC_KEYS = ('iou_topk', 'beta_topk', 'initial_iou', 'initial_beta',
                'update_iter_interval')


def build_dynamic_roi_head(cfg: dict, common: dict, rcnn_train: dict):
    """``DynamicRoIHead`` (JAX ``builder.py:437-447``): it assigns with one
    threshold for positives, negatives and low-quality matches and trains
    a class-specific SmoothL1 box loss whose beta starts at
    ``initial_beta``; a config whose assigner or box loss says otherwise
    is refused."""
    dyn = _cfg(rcnn_train.get('dynamic_rcnn'))
    _check_keys('dynamic_rcnn', dyn, DYNAMIC_KEYS, item=DROPPED)
    kw = dict(iou_topk=dyn.get('iou_topk', 75),
              beta_topk=dyn.get('beta_topk', 10),
              initial_iou=dyn.get('initial_iou', 0.4),
              initial_beta=dyn.get('initial_beta', 1.0),
              update_iter_interval=dyn.get('update_iter_interval', 100))
    assigner = _cfg(rcnn_train.get('assigner'))
    thr = assigner.get('pos_iou_thr', 0.5)
    loss = _cfg(_cfg(cfg['bbox_head']).get('loss_bbox'))
    if (assigner.get('neg_iou_thr', 0.5), assigner.get('min_pos_iou', 0.5)
            ) != (thr, thr) or loss.get('type') != 'SmoothL1Loss' or \
            loss.get('beta', 1.0) != kw['initial_beta'] or \
            common['bbox_head'].reg_class_agnostic or \
            common['reg_decoded_bbox']:
        raise not_ported('a DynamicRoIHead with other assigner thresholds, '
                         'box loss or beta than the one dynamic threshold '
                         'and SmoothL1 from initial_beta JAX trains with',
                         DROPPED)
    return DynamicRoIHead(**kw, **common)


# the keys of the cascade heads that the JAX builders read
# (``dynamask_tpu/models/builder.py:531-580``, ``htc.py:385-460``); the
# semantic head's ``ignore_label`` is 255 there whatever the config says
CASCADE_KEYS = ('bbox_head', 'bbox_roi_extractor', 'mask_roi_extractor',
                'mask_head', 'num_stages', 'stage_loss_weights')
HTC_KEYS = ('interleaved', 'mask_info_flow', 'semantic_roi_extractor',
            'semantic_head', 'semantic_fusion')
HTC_MASK_KEYS = ('type', 'num_convs', 'in_channels', 'conv_out_channels',
                 'num_classes', 'class_agnostic', 'with_conv_res',
                 'loss_mask')
SEMANTIC_KEYS = ('type', 'num_ins', 'fusion_level', 'num_convs',
                 'in_channels', 'conv_out_channels', 'num_classes',
                 'loss_weight')


def _test_nms(nms_cfg: dict) -> dict:
    """``multiclass_nms``'s options from ``test_cfg.rcnn.nms``: greedy, or
    linear Soft-NMS with its ``sigma`` and ``min_score`` (JAX
    ``builder.py:345-348``; JAX reads no ``method``, so only linear)."""
    t = nms_cfg.get('type', 'nms')
    if t == 'nms':
        return {}
    if t != 'soft_nms':
        raise not_ported(f'test nms type {t}', UNQUEUED)
    _check_keys('soft_nms', nms_cfg, ('type', 'iou_threshold', 'sigma',
                                      'min_score'), {'method': 'linear'},
                DROPPED)
    return dict(nms_type='soft_nms', sigma=nms_cfg.get('sigma', 0.5),
                min_score=nms_cfg.get('min_score', 1e-3))


def _cascade_losses(t: str, stages) -> dict:
    """The stage heads' losses as the JAX cascade heads apply them: loss
    weights 1 (they pass none), stage 0's regression loss on every stage
    (``cascade_roi_head.py:107-115``), and under HTC an L1 loss whatever
    the config names (``htc.py:235-237``; ROADMAP.md queue 3, 3l)."""
    losses = [_box_losses(cfg) for _, _, cfg in stages]
    reg = ('smooth_l1_beta', 'reg_loss_type', 'reg_decoded_bbox')
    for i, lo in enumerate(losses):
        if (lo['loss_cls_weight'], lo['loss_bbox_weight']) != (1.0, 1.0):
            raise not_ported(f'{t} stage {i} loss weights {lo} (the JAX '
                             'cascade heads apply 1)', 'no item')
        if any(lo[k] != losses[0][k] for k in reg):
            raise not_ported(f'{t} stage {i} regression loss other than '
                             'stage 0\'s', 'no item')
    if t == 'HybridTaskCascadeRoIHead':
        return dict(loss_cls_weight=1.0, loss_bbox_weight=1.0,
                    smooth_l1_beta=None, reg_loss_type=None,
                    reg_decoded_bbox=False)
    return dict(loss_cls_weight=1.0, loss_bbox_weight=1.0,
                **{k: losses[0][k] for k in reg})


def _stage_thresholds(t: str, stage_train, n: int) -> tuple:
    """Each stage's IoU threshold: JAX reads ``pos_iou_thr`` alone and
    assigns with ``pos = neg = min_pos`` and no low-quality matches, on
    stage 0's sampler (``cascade_roi_head.py:42-65``); other stage
    settings are refused."""
    if len(stage_train) == 1 and not stage_train[0] and n == 3:
        return (0.5, 0.6, 0.7)
    if len(stage_train) != n:
        raise not_ported(f'{t}: {len(stage_train)} train_cfg.rcnn stages '
                         f'for {n} heads', 'no item')
    s0 = _cfg(stage_train[0].get('sampler'))
    thrs = []
    for i, st in enumerate(stage_train):
        a, smp = _cfg(st.get('assigner')), _cfg(st.get('sampler'))
        thr = a.get('pos_iou_thr', 0.5)
        if (a.get('neg_iou_thr', thr), a.get('min_pos_iou', thr),
                a.get('match_low_quality', False)) != (thr, thr, False):
            raise not_ported(f'{t} stage {i} assigner {a}', 'no item')
        if (smp.get('num', 512), smp.get('pos_fraction', 0.25)) != (
                s0.get('num', 512), s0.get('pos_fraction', 0.25)):
            raise not_ported(f'{t} stage {i} sampler {smp} other than '
                             'stage 0\'s', 'no item')
        thrs.append(thr)
    return tuple(thrs)


def build_cascade_roi_head(t: str, cfg: dict, stages, stage_train,
                           common: dict, bbox_extractor: dict):
    """``CascadeRoIHead`` or ``HybridTaskCascadeRoIHead`` from the
    configs' schema, as the JAX builders read it."""
    htc = t == 'HybridTaskCascadeRoIHead'
    _check_keys(t, cfg, CASCADE_KEYS + (HTC_KEYS if htc else ()))
    n = cfg.get('num_stages', len(stages))
    weights = tuple(cfg.get('stage_loss_weights', (1.0, 0.5, 0.25)))
    if len(stages) != n or len(weights) != n:
        raise not_ported(f'{t}: {len(stages)} heads, {len(weights)} loss '
                         f'weights for num_stages {n}', 'no item')
    for i, (head, _, _) in enumerate(stages):
        if head.num_classes != common['num_classes']:
            raise not_ported(f'{t} stage {i} num_classes', 'no item')
    common.update(_cascade_losses(t, stages))
    kw = dict(bbox_head=[h for h, _, _ in stages],
              stage_loss_weights=weights,
              stage_pos_iou_thr=_stage_thresholds(t, stage_train, n),
              stage_target_stds=tuple(
                  tuple(c.get('target_stds', (0.1, 0.1, 0.2, 0.2)))
                  for _, c, _ in stages), **common)
    means = {tuple(c.get('target_means', (0., 0., 0., 0.)))
             for _, c, _ in stages}
    if len(means) != 1:
        raise not_ported(f'{t}: stage target_means other than stage 0\'s',
                         'no item')
    mhc = cfg.get('mask_head')
    if not htc:
        if mhc is None:
            return CascadeRoIHead(mask_head=None, **kw)
        mhc = _cfg(mhc) if isinstance(mhc, dict) else mhc
        if not isinstance(mhc, dict) or mhc.pop('type', None) != \
                'FCNMaskHead':
            raise not_ported(f'{t} mask head {mhc} (the port has one '
                             'FCNMaskHead, as the JAX builder)',
                             UNQUEUED)
        if _cfg(mhc.get('loss_mask')).get('loss_weight', 1.0) != 1.0:
            raise not_ported(f'{t} mask loss weight (JAX applies 1)',
                             'no item')
        return CascadeRoIHead(mask_head=build_fcn_mask_head(mhc), **kw)
    return build_htc_roi_head(cfg, mhc, n, stage_train, bbox_extractor, kw)


def build_htc_roi_head(cfg: dict, mhc, n: int, stage_train,
                       bbox_extractor: dict, kw: dict):
    """``HybridTaskCascadeRoIHead`` (JAX ``htc.py:385-460``): an
    ``HTCMaskHead`` a stage (one dict repeats), the ``FusedSemanticHead``
    and its extractor's stride, ``mask_size`` from the first stage's
    train config."""
    t = 'HybridTaskCascadeRoIHead'
    if not cfg.get('mask_info_flow', True):
        raise not_ported(f'{t} mask_info_flow=False (the JAX test path '
                         'flows whatever it says)', 'no item')
    if not cfg.get('interleaved', True) or set(cfg.get(
            'semantic_fusion', ('bbox', 'mask'))) != {'bbox', 'mask'}:
        raise not_ported(f'{t} interleaved=False or a semantic_fusion other '
                         'than (bbox, mask): no config uses them', 'no item')
    mask_cfgs = [mhc] * n if isinstance(mhc, dict) else list(mhc or ())
    if len(mask_cfgs) != n:
        raise not_ported(f'{t}: {len(mask_cfgs)} mask heads for {n} stages',
                         'no item')
    mask_heads, mask_weights = [], set()
    for mc in map(_cfg, mask_cfgs):
        if mc.get('type') != 'HTCMaskHead':
            raise not_ported(f'{t} mask head {mc.get("type")}', UNQUEUED)
        _check_keys('HTCMaskHead', mc, HTC_MASK_KEYS)
        loss = _check_loss('HTCMaskHead loss_mask', mc.get('loss_mask'),
                           ('CrossEntropyLoss',))
        if not loss.get('use_mask', True):
            raise not_ported('an HTCMaskHead loss_mask without use_mask',
                             'no item')
        mask_weights.add(loss.get('loss_weight', 1.0))
        mask_heads.append(HTCMaskHead(
            with_conv_res=mc.get('with_conv_res', True),
            num_convs=mc.get('num_convs', 4),
            in_channels=mc.get('in_channels', 256),
            conv_out_channels=mc.get('conv_out_channels', 256),
            num_classes=mc.get('num_classes', 80),
            class_agnostic=mc.get('class_agnostic', False)))
    if len(mask_weights) != 1:
        raise not_ported(f'{t} mask loss weights {mask_weights}', 'no item')
    semantic_head, stride, sem_weight = None, 8, 0.2
    sc = _cfg(cfg.get('semantic_head'))
    if sc:
        if sc.get('type') != 'FusedSemanticHead':
            raise not_ported(f'semantic head {sc.get("type")}', 'no item')
        _check_keys('FusedSemanticHead', sc, SEMANTIC_KEYS,
                    {'ignore_label': 255})
        sre = _extractor(cfg.get('semantic_roi_extractor'),
                         'semantic_roi_extractor')
        strides = tuple(sre.get('featmap_strides', (8,)))
        fl = sc.get('fusion_level', 1)
        levels = tuple(bbox_extractor.get('featmap_strides', (4, 8, 16, 32)))
        if len(strides) != 1 or fl >= len(levels) or levels[fl] != \
                strides[0]:
            raise not_ported(f'semantic fusion level {fl} (stride '
                             f'{levels[fl] if fl < len(levels) else "?"}) '
                             f'other than its extractor\'s {strides}',
                             'no item')
        stride = strides[0]
        sem_weight = sc.get('loss_weight', 0.2)
        semantic_head = FusedSemanticHead(
            num_ins=sc.get('num_ins', 5), fusion_level=fl,
            num_convs=sc.get('num_convs', 4),
            in_channels=sc.get('in_channels', 256),
            conv_out_channels=sc.get('conv_out_channels', 256),
            num_classes=sc.get('num_classes', 183))
    elif cfg.get('semantic_roi_extractor'):
        raise not_ported(f'{t}: a semantic extractor without a semantic '
                         'head', 'no item')
    kw['loss_mask_weight'] = mask_weights.pop()
    return HybridTaskCascadeRoIHead(
        mask_head=mask_heads, semantic_head=semantic_head,
        semantic_out_stride=stride, semantic_loss_weight=sem_weight,
        mask_size=stage_train[0].get('mask_size', 28), **kw)


def _rpn_cfg(anchor_cfg: dict, coder: dict, rpn_head_cfg: dict,
             train_cfg: dict, test: dict) -> dict:
    """The detector's RPN options: anchors, coder, train_cfg.rpn's
    assigner and sampler, loss weights, and the test proposals of ``test``
    (``nms_pre``, ``max_num``, ``nms_thr``)."""
    rpn_train = _cfg(_cfg(train_cfg).get('rpn'))
    rpn_assigner = _cfg(rpn_train.get('assigner'))
    rpn_sampler = _cfg(rpn_train.get('sampler'))
    # its ``neg_pos_ub`` is dropped as the JAX builder drops it (it samples
    # the RPN by ``num`` and ``pos_fraction`` alone, builder.py:1203-1207):
    # Libra R-CNN's 5 is computed without the cap (ROADMAP.md queue 3, 3bn)
    _check_sampling('rpn', rpn_assigner, rpn_sampler)
    rpn_proposal = _cfg(_cfg(train_cfg).get('rpn_proposal'))
    return dict(
        anchor_scales=tuple(anchor_cfg.get('scales', (8,))),
        anchor_ratios=tuple(anchor_cfg.get('ratios', (0.5, 1.0, 2.0))),
        anchor_strides=tuple(anchor_cfg.get('strides', (4, 8, 16, 32, 64))),
        rpn_target_means=tuple(coder.get('target_means', (0., 0., 0., 0.))),
        rpn_target_stds=tuple(coder.get('target_stds', (1., 1., 1., 1.))),
        rpn_nms_pre_test=test['nms_pre'], rpn_max_num=test['max_num'],
        rpn_nms_thr=test['nms_thr'],
        rpn_nms_pre_train=rpn_proposal.get('nms_pre', 2000),
        rpn_pos_iou_thr=rpn_assigner.get('pos_iou_thr', 0.7),
        rpn_neg_iou_thr=rpn_assigner.get('neg_iou_thr', 0.3),
        rpn_min_pos_iou=rpn_assigner.get('min_pos_iou', 0.3),
        rpn_num_samples=rpn_sampler.get('num', 256),
        rpn_pos_fraction=rpn_sampler.get('pos_fraction', 0.5),
        rpn_cls_weight=_cfg(rpn_head_cfg.get('loss_cls')).get('loss_weight',
                                                               1.0),
        rpn_bbox_weight=_cfg(rpn_head_cfg.get('loss_bbox')).get(
            'loss_weight', 1.0))


# the keys of guided anchoring's heads and trainers that the JAX builders
# read (``dynamask_tpu/models/builder.py:658-697, :826-877``); the others
# at the values JAX computes with (3w)
GA_HEAD_KEYS = ('type', 'in_channels', 'feat_channels', 'deform_groups',
                'approx_anchor_generator', 'square_anchor_generator',
                'anchor_coder', 'bbox_coder', 'loc_filter_thr', 'loss_loc',
                'loss_shape', 'loss_cls', 'loss_bbox')
GA_FOCAL = dict(type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
                loss_weight=1.0)
ZERO4 = (0., 0., 0., 0.)


def ga_anchor_cfg(hc: dict, strides, octave_base_scale: float) -> dict:
    """The approx generator's octave scales, ratios and strides; the square
    generator, which JAX does not read, only as it builds it (ratio 1 at
    the octave base scale on the approx strides)."""
    a = _cfg(hc.get('approx_anchor_generator'))
    _check_keys('approx_anchor_generator', a, (
        'type', 'octave_base_scale', 'scales_per_octave', 'ratios',
        'strides'), {'center_offset': 0.0}, DROPPED)
    if a.get('type', 'AnchorGenerator') != 'AnchorGenerator':
        raise not_ported(f'approx anchor generator {a["type"]}', DROPPED)
    out = dict(octave_base_scale=a.get('octave_base_scale',
                                       octave_base_scale),
               scales_per_octave=a.get('scales_per_octave', 3),
               anchor_ratios=tuple(a.get('ratios', (0.5, 1.0, 2.0))),
               anchor_strides=tuple(a.get('strides', strides)))
    sq = _cfg(hc.get('square_anchor_generator'))
    _check_keys('square_anchor_generator', sq, (), dict(
        type='AnchorGenerator', ratios=[1.0],
        scales=[out['octave_base_scale']],
        strides=list(out['anchor_strides']), center_offset=0.0), DROPPED)
    return out


def ga_losses(hc: dict, cls_loss: dict) -> dict:
    """The GA heads' losses as JAX applies them: its focal location loss
    (gamma 2, alpha 0.25) and ``cls_loss``, both at weight 1; the bounded
    IoU shape loss's and the SmoothL1 box loss's ``beta``."""
    _check_keys('loss_loc', _cfg(hc.get('loss_loc')), (), GA_FOCAL, DROPPED)
    _check_keys('loss_cls', _cfg(hc.get('loss_cls')), (), cls_loss, DROPPED)
    ls = _cfg(hc.get('loss_shape'))
    _check_keys('loss_shape', ls, ('beta',), dict(
        type='BoundedIoULoss', loss_weight=1.0, eps=1e-3), DROPPED)
    lb = _cfg(hc.get('loss_bbox'))
    _check_keys('GA loss_bbox', lb, ('beta',), dict(
        type='SmoothL1Loss', loss_weight=1.0), DROPPED)
    return dict(shape_beta=ls.get('beta', 0.2), beta=lb.get('beta'))


def ga_train_cfg(tr: dict, extra=()) -> dict:
    """A GA head's training config: the ``ga_assigner`` (approx max IoU)
    and ``ga_sampler`` (random, no GTs added) and the region ratios; ->
    the keyword arguments they give."""
    ga_as, ga_sm = _cfg(tr.get('ga_assigner')), _cfg(tr.get('ga_sampler'))
    _check_keys('ga_assigner', ga_as, ('pos_iou_thr', 'neg_iou_thr',
                                       'min_pos_iou'),
                dict(type='ApproxMaxIoUAssigner', ignore_iof_thr=-1,
                     gt_max_assign_all=True, match_low_quality=True),
                DROPPED)
    _check_keys('ga_sampler', ga_sm, ('num', 'pos_fraction'), dict(
        type='RandomSampler', neg_pos_ub=-1, add_gt_as_proposals=False),
        DROPPED)
    _check_keys('GA train_cfg', tr, ('ga_assigner', 'ga_sampler',
                                     'center_ratio', 'ignore_ratio') +
                tuple(extra),
                {'allowed_border': -1, 'pos_weight': -1, 'debug': False},
                DROPPED)
    return dict(ga_pos_iou_thr=ga_as.get('pos_iou_thr', 0.7),
                ga_neg_iou_thr=ga_as.get('neg_iou_thr', 0.3),
                ga_min_pos_iou=ga_as.get('min_pos_iou', 0.3),
                ga_sample_num=ga_sm.get('num', 256),
                ga_pos_fraction=ga_sm.get('pos_fraction', 0.5),
                center_ratio=tr.get('center_ratio', 0.2),
                ignore_ratio=tr.get('ignore_ratio', 0.5))


def build_ga_rpn_family(t: str, cfg: dict, train_cfg: dict, test_cfg: dict,
                        modules: dict):
    """GA-RPN (``RPN``) and GA-Faster R-CNN (``FasterRCNN``) over a
    ``GARPNHead`` (JAX ``builder.py:826-877``). ``anchor_coder`` is read
    by neither package's code path: the guided anchors are decoded with
    unit stds (3aq), logged, not refused, as every file of the family
    names other stds. The proposals take ``max_num`` and ``nms_thr`` from
    ``train_cfg.rpn_proposal`` at test time too, as in JAX."""
    from .guided_anchor import GAFasterRCNN, GARPN, GARPNHead
    hc = _cfg(cfg['rpn_head'])
    _check_keys('GARPNHead', hc, GA_HEAD_KEYS, item=DROPPED)
    coders = [_cfg(hc.get(k)) for k in ('anchor_coder', 'bbox_coder')]
    for name, coder in zip(('anchor_coder', 'bbox_coder'), coders):
        _check_coder(f'GARPNHead {name}', coder)
        if tuple(coder.get('target_means', ZERO4)) != ZERO4:
            raise not_ported(f'GARPNHead {name} target_means (JAX decodes '
                             'with zero means)', DROPPED)
    losses = ga_losses(hc, dict(type='CrossEntropyLoss', use_sigmoid=True,
                                loss_weight=1.0))
    tr = _cfg(train_cfg)
    rpn_tr = _cfg(tr.get('rpn'))
    asg, smp = _cfg(rpn_tr.get('assigner')), _cfg(rpn_tr.get('sampler'))
    _check_sampling('rpn', asg, smp)
    _check_keys('GA rpn assigner', asg, ('type', 'pos_iou_thr',
                                         'neg_iou_thr', 'min_pos_iou'),
                {'match_low_quality': True, 'ignore_iof_thr': -1,
                 'gt_max_assign_all': True}, DROPPED)
    _check_keys('GA rpn sampler', smp, ('type', 'num', 'pos_fraction'),
                {'neg_pos_ub': -1, 'add_gt_as_proposals': False}, DROPPED)
    kw = ga_train_cfg(rpn_tr, ('assigner', 'sampler'))
    proposal = _cfg(tr.get('rpn_proposal'))
    test = _cfg(_cfg(test_cfg).get('rpn'))
    prop = dict(max_num=proposal.get('max_num', 300),
                nms_thr=proposal.get('nms_thr', 0.7))
    for k, v in prop.items():
        if test.get(k, v) != v:
            raise not_ported(f'GA test_cfg.rpn {k} {test[k]} other than '
                             f'rpn_proposal\'s {v} (JAX takes the latter at '
                             'test time)', DROPPED)
    args = dict(
        **ga_anchor_cfg(hc, (4, 8, 16, 32, 64), 8), **kw,
        target_stds=tuple(coders[1].get('target_stds',
                                        (0.07, 0.07, 0.11, 0.11))),
        rpn_pos_iou_thr=asg.get('pos_iou_thr', 0.7),
        rpn_neg_iou_thr=asg.get('neg_iou_thr', 0.3),
        rpn_min_pos_iou=asg.get('min_pos_iou', 0.3),
        rpn_num_samples=smp.get('num', 256),
        rpn_pos_fraction=smp.get('pos_fraction', 0.5),
        shape_beta=losses['shape_beta'],
        rpn_beta=1.0 if losses['beta'] is None else losses['beta'],
        loc_filter_thr=hc.get('loc_filter_thr', 0.01),
        rpn_nms_pre_train=proposal.get('nms_pre', 2000),
        rpn_nms_pre_test=test.get('nms_pre', 1000),
        rpn_max_num=prop['max_num'], rpn_nms_thr=prop['nms_thr'])
    head = GARPNHead(hc.get('in_channels', 256), hc.get('feat_channels', 256),
                     hc.get('deform_groups', 4))
    if t == 'RPN':
        return GARPN(rpn_head=head, **modules, **args)
    return GAFasterRCNN(rpn_head=head, **modules, **args)


DETECTOR_TYPES = ('MaskRCNN', 'FasterRCNN', 'FastRCNN', 'RPN')
# the detectors the JAX package builds as its ``TwoStageDetector`` by
# another name (``dynamask_tpu/models/builder.py:1176-1180``): the port's
# two-stage one
TWO_STAGE_DETECTORS = ('CascadeRCNN', 'HybridTaskCascade', 'GridRCNN',
                     'MaskScoringRCNN', 'PointRend')


def build_detector(model_cfg: dict, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None, device=None,
                   seed: int = 0, init_std: Optional[float] = None):
    """The detector of ``model_cfg`` on ``device`` (default ``cuda``; raises
    without a GPU unless ``device='cpu'``; ``'meta'`` gives the structure
    without weights), its weights drawn from a ``torch.Generator`` seeded
    with ``seed`` (see :func:`dynamask_torch.models.layers.init_weights`
    for ``init_std``). ``MaskRCNN`` and ``FasterRCNN`` (the two-stage
    detectors), ``FastRCNN`` (the RoI head over the batch's proposals) and
    ``RPN`` (the proposals alone); ``CascadeRCNN``,
    ``HybridTaskCascade``, ``GridRCNN``, ``MaskScoringRCNN`` and
    ``PointRend`` build the two-stage detector on their RoI heads;
    ``RetinaNet`` (and ``SingleStageDetector``), ``ATSS`` and ``FCOS``
    the single-stage ones."""
    dev = resolve_device(device)
    cfg = _cfg(model_cfg)
    t = cfg.pop('type')
    cfg.pop('pretrained', None)
    from .single_stage_builder import (SINGLE_STAGE, SSD_HEADS, build_ssd,
                                       build_single_stage)
    if _cfg(cfg.get('bbox_head')).get('type') in SSD_HEADS:
        # SSD has no neck: it goes before the neck's C4 refusal
        if t != 'SingleStageDetector':
            raise not_ported(f'an SSD head under {t}', 'no item')
        with torch.device('meta'):
            det = build_ssd(cfg, train_cfg, test_cfg)
        return _materialise(det, dev, seed, init_std)
    if t == 'CornerNet':
        with torch.device('meta'):
            det = build_cornernet(cfg, train_cfg, test_cfg)
        return _materialise(det, dev, seed, init_std)
    if t in SINGLE_STAGE:
        with torch.device('meta'):
            det = build_single_stage(t, cfg, train_cfg, test_cfg, dict(
                backbone=build_backbone(cfg['backbone']),
                neck=build_neck(cfg.get('neck'))))
        return _materialise(det, dev, seed, init_std)
    if t not in DETECTOR_TYPES + TWO_STAGE_DETECTORS:
        raise not_ported(f'detector {t}', 'no item')
    parts = {'backbone', 'neck'} | (set() if t == 'RPN' else {'roi_head'}) | \
        (set() if t == 'FastRCNN' else {'rpn_head'})
    with torch.device('meta'):
        modules = dict(backbone=build_backbone(cfg['backbone']),
                       neck=build_neck(cfg.get('neck')))
        # the proposal files name ``roi_head=None`` (rpn_r50_caffe_c4)
        _check_keys(t, cfg, parts, {'roi_head': None})
        if _cfg(cfg.get('rpn_head')).get('type') == 'GARPNHead':
            if t not in ('RPN', 'FasterRCNN'):
                raise not_ported(f'a GARPNHead under {t} (the port has GA-RPN '
                                 'and GA-Faster R-CNN)', 'no item')
            if t != 'RPN':
                modules['roi_head'] = build_roi_head(cfg['roi_head'],
                                                     train_cfg, test_cfg)
            det = build_ga_rpn_family(t, cfg, train_cfg, test_cfg, modules)
            return _materialise(det, dev, seed, init_std)
        if t != 'RPN':
            modules['roi_head'] = build_roi_head(cfg['roi_head'], train_cfg,
                                                 test_cfg)
        if t != 'FastRCNN':
            modules['rpn_head'], anchor_cfg, coder = build_rpn_head(
                cfg['rpn_head'])
    if t == 'RPN':
        # the proposal detector's test NMS is test_cfg.rpn's (JAX
        # builder.py:1170-1173)
        rpn_test = _cfg(_cfg(test_cfg).get('rpn'))
        test = dict(nms_pre=rpn_test.get('nms_pre', 2000),
                    max_num=rpn_test.get('max_num',
                                         rpn_test.get('nms_post', 2000)),
                    nms_thr=rpn_test.get('nms_thr', 0.7))
    else:
        # the two-stage detectors take max_num and nms_thr from
        # train_cfg.rpn_proposal, as the JAX builder does (builder.py:
        # 1208-1211)
        proposal = _cfg(_cfg(train_cfg).get('rpn_proposal'))
        test = dict(nms_pre=_cfg(_cfg(test_cfg).get('rpn')).get('nms_pre',
                                                                1000),
                    max_num=proposal.get('max_num', 1000),
                    nms_thr=proposal.get('nms_thr', 0.7))
    if t != 'FastRCNN':
        modules.update(_rpn_cfg(anchor_cfg, coder, model_cfg['rpn_head'],
                                train_cfg, test))
    if t in TWO_STAGE_DETECTORS:
        t = 'FasterRCNN' if modules['roi_head'].mask_head is None else \
            'MaskRCNN'
    return _materialise(DETECTORS.build(dict(type=t, **modules)), dev, seed,
                        init_std)


# CornerNet's keys as the JAX builder reads them (``builder.py:1026-1048``):
# the head's loss types and weights fixed (its heatmap loss is the Gaussian
# focal loss at alpha 2 and gamma 4, its offset loss SmoothL1, each of
# weight 1), the test NMS a Gaussian Soft-NMS of sigma 0.5
CORNER_HEAD_KEYS = ('type', 'num_classes', 'in_channels', 'num_feat_levels',
                    'corner_emb_channels', 'loss_heatmap', 'loss_embedding',
                    'loss_offset')
CORNER_TEST_KEYS = ('corner_topk', 'local_maximum_kernel',
                    'distance_threshold', 'num_dets', 'score_thr',
                    'max_per_img', 'nms_cfg')


def build_cornernet(cfg: dict, train_cfg, test_cfg):
    """``CornerNet`` over ``HourglassNet`` and ``CornerHead``, no neck."""
    from .cornernet import CornerHead, CornerNet
    _check_keys('CornerNet', cfg, ('backbone', 'bbox_head'), {'neck': None},
                DROPPED)
    if _cfg(train_cfg):
        raise not_ported(f'CornerNet train_cfg {train_cfg}', DROPPED)
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'CornerHead':
        raise not_ported(f'CornerNet head {hc.get("type")}', UNQUEUED)
    _check_keys('CornerHead', hc, CORNER_HEAD_KEYS, item=DROPPED)
    _check_keys('CornerHead loss_heatmap', _cfg(hc.get('loss_heatmap')), (),
                dict(type='GaussianFocalLoss', alpha=2.0, gamma=4.0,
                     loss_weight=1), DROPPED)
    emb = _cfg(hc.get('loss_embedding'))
    _check_keys('CornerHead loss_embedding', emb, (
        'pull_weight', 'push_weight'), {'type': 'AssociativeEmbeddingLoss'},
                DROPPED)
    off = _cfg(hc.get('loss_offset'))
    _check_keys('CornerHead loss_offset', off, ('beta',),
                dict(type='SmoothL1Loss', loss_weight=1), DROPPED)
    tc = _cfg(test_cfg)
    _check_keys('CornerNet test_cfg', tc, CORNER_TEST_KEYS, item=DROPPED)
    nms = _cfg(tc.get('nms_cfg'))
    _check_keys('CornerNet test_cfg.nms_cfg', nms, ('iou_threshold',), dict(
        type='soft_nms', method='gaussian', sigma=0.5), DROPPED)
    num_classes = hc.get('num_classes', 80)
    head = CornerHead(num_classes=num_classes,
                      in_channels=hc.get('in_channels', 256),
                      num_feat_levels=hc.get('num_feat_levels', 2),
                      corner_emb_channels=hc.get('corner_emb_channels', 1))
    return CornerNet(
        build_backbone(cfg['backbone']), head, num_classes=num_classes,
        pull_weight=emb.get('pull_weight', 0.25),
        push_weight=emb.get('push_weight', 0.25),
        offset_beta=off.get('beta', 1.0),
        corner_topk=tc.get('corner_topk', 100),
        local_maximum_kernel=tc.get('local_maximum_kernel', 3),
        distance_threshold=tc.get('distance_threshold', 0.5),
        num_dets=tc.get('num_dets', 1000), score_thr=tc.get('score_thr', 0.05),
        nms_iou_thr=nms.get('iou_threshold', 0.5),
        max_per_img=tc.get('max_per_img', 100))


def _materialise(det, dev: torch.device, seed: int,
                 init_std: Optional[float]):
    """``det``, built on the ``meta`` device, with its frozen stages frozen,
    materialised on ``dev`` and initialised from ``seed``, in eval mode
    and ``channels_last``; on ``meta``, its structure alone."""
    for m in det.modules():     # the RFP's backbones' stages too
        if isinstance(m, Backbone):
            m.freeze_stages()
    if dev.type == 'meta':
        return det.eval()
    det = det.to_empty(device=dev)
    init_weights(det, torch.Generator(device=dev).manual_seed(seed), init_std)
    if init_std is None and isinstance(getattr(det, 'roi_head', None),
                                       DynaMaskRoIHead):
        with torch.no_grad():
            det.roi_head.mask_head.loss_func.detail_target.fuse_kernel.copy_(
                torch.tensor([0.7, 0.3]).reshape(1, 2, 1, 1))
    return det.eval().to(memory_format=torch.channels_last)
