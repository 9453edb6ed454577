"""Build the single-stage detectors from a reference-schema config (port
of the parts of ``dynamask_tpu/models/builder.py`` that build them:
``build_single_stage`` :614-770 for RetinaNet, its GHM, legacy v1 and
SepBN forms, FreeAnchor and GA-RetinaNet (:658-697), and
``build_detector``'s ATSS :886-915 and FCOS :1082-1127).

As in ``models/builder.py``, every key that changes the model is read or
refused, naming the ROADMAP.md item where its port is queued or the JAX
fault that fixes it: the keys the JAX builder drops are accepted only at
the value JAX computes with (ROADMAP.md queue 3, 3w), but for two faults
the configs rely on, which the port reproduces: GHM's ``momentum``
(3ab: the losses are momentum-free) and RetinaNet's ``SmoothL1Loss`` (3af:
it regresses with L1, whatever the type).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .atss import ATSS, ATSSHead
from .builder import (DROPPED, GA_HEAD_KEYS, _cfg, _check_keys, ga_anchor_cfg,
                      ga_losses, ga_train_cfg, not_ported)
from .fcos import FCOS, FCOSHead, INF
from .freeanchor import FreeAnchor
from .single_stage import RetinaHead, RetinaNet, RetinaSepBNHead

SINGLE_STAGE = ('RetinaNet', 'SingleStageDetector', 'ATSS', 'FCOS')
# the dense heads the port lacks, by ROADMAP.md item
HEAD_ITEMS = {'PISARetinaHead': 9, 'SSDHead': 6, 'PISASSDHead': 9,
              'NASFCOSHead': 6}
FOCAL = dict(type='FocalLoss', use_sigmoid=True, gamma=2.0, alpha=0.25,
             loss_weight=1.0)
CENTERNESS = dict(type='CrossEntropyLoss', use_sigmoid=True, loss_weight=1.0)
TEST_KEYS = ('nms_pre', 'score_thr', 'nms', 'max_per_img')


def _test_cfg(test_cfg: dict, iou_default: float) -> dict:
    """``nms_pre``, ``score_thr``, greedy NMS's ``iou_threshold`` and
    ``max_per_img``; ``min_bbox_size`` only at 0, which JAX reads not."""
    tc = _cfg(test_cfg)
    _check_keys('single-stage test_cfg', tc, TEST_KEYS,
                {'min_bbox_size': 0}, DROPPED)
    nms = _cfg(tc.get('nms'))
    _check_keys('single-stage test_cfg.nms', nms, ('iou_threshold',),
                {'type': 'nms'}, DROPPED)
    return dict(nms_pre=tc.get('nms_pre', 1000),
                score_thr=tc.get('score_thr', 0.05),
                nms_iou_thr=nms.get('iou_threshold', iou_default),
                max_per_img=tc.get('max_per_img', 100))


def _train_cfg(train_cfg: dict, assigner_type: Optional[str] = None,
               assigner_keys=()) -> dict:
    """The train_cfg's assigner (of ``assigner_type``, its
    ``assigner_keys`` read; none without a type) and the keys mmdet's
    dense heads read at their defaults; -> the assigner's config."""
    tr = _cfg(train_cfg)
    _check_keys('single-stage train_cfg', tr,
                ('assigner',) if assigner_type else (),
                {'allowed_border': -1, 'pos_weight': -1, 'debug': False},
                DROPPED)
    a = _cfg(tr.get('assigner'))
    if a.get('type', assigner_type) != assigner_type:
        raise not_ported(f'assigner {a["type"]} of a single-stage head', 9)
    _check_keys(assigner_type, a, ('type',) + tuple(assigner_keys),
                {'ignore_iof_thr': -1, 'gt_max_assign_all': True}, DROPPED)
    return a


def _anchors(hc: dict, legacy: bool) -> dict:
    """RetinaNet's ``anchor_generator``: the octave scales, ratios and
    strides (JAX reads no ``scales`` and no ``center_offset``, which the
    legacy form fixes at 0.5)."""
    a = _cfg(hc.get('anchor_generator'))
    _check_keys('anchor_generator', a, (
        'type', 'octave_base_scale', 'scales_per_octave', 'ratios',
        'strides'), {'center_offset': 0.5 if legacy else 0.0}, DROPPED)
    return dict(anchor_octave_base_scale=a.get('octave_base_scale', 4),
                anchor_scales_per_octave=a.get('scales_per_octave', 3),
                anchor_ratios=tuple(a.get('ratios', (0.5, 1.0, 2.0))),
                anchor_strides=tuple(a.get('strides', (8, 16, 32, 64, 128))))


def _coder(hc: dict, default_stds) -> dict:
    c = _cfg(hc.get('bbox_coder'))
    _check_keys('bbox_coder', c, ('type', 'target_means', 'target_stds'),
                {'clip_border': True}, DROPPED)
    return dict(target_means=tuple(c.get('target_means', (0., 0., 0., 0.))),
                target_stds=tuple(c.get('target_stds', default_stds)))


def _legacy(hc: dict) -> bool:
    """The v1.x anchors and coder go together: JAX takes both when either
    is named (``builder.py:722-725``)."""
    kinds = {'Legacy' in _cfg(hc.get(k)).get('type', '')
             for k in ('anchor_generator', 'bbox_coder')}
    if len(kinds) != 1:
        raise not_ported('a legacy anchor generator without the legacy '
                         'coder, or the reverse (JAX takes both)', DROPPED)
    return kinds.pop()


def _retina_losses(hc: dict) -> dict:
    """Focal or GHM-C; L1 (for ``L1Loss`` and ``SmoothL1Loss``, 3af) or
    GHM-R."""
    lc = _cfg(hc.get('loss_cls')) or dict(FOCAL)
    lb = _cfg(hc.get('loss_bbox')) or dict(type='L1Loss')
    out = {}
    if lc.get('type') == 'GHMC':
        # momentum: read, not applied (3ab)
        _check_keys('GHMC', lc, ('type', 'bins', 'momentum', 'loss_weight'),
                    {'use_sigmoid': True}, DROPPED)
        out.update(cls_loss_type='ghmc', ghm_c_bins=lc.get('bins', 30),
                   loss_cls_weight=lc.get('loss_weight', 1.0))
    elif lc.get('type') == 'FocalLoss':
        _check_keys('FocalLoss', lc, ('type', 'gamma', 'alpha'),
                    {'use_sigmoid': True, 'loss_weight': 1.0}, DROPPED)
        out.update(focal_gamma=lc.get('gamma', 2.0),
                   focal_alpha=lc.get('alpha', 0.25))
    else:
        raise not_ported(f'RetinaNet loss_cls {lc.get("type")}', 6)
    t = lb.get('type')
    if t == 'GHMR':
        _check_keys('GHMR', lb, ('type', 'mu', 'bins', 'momentum',
                                 'loss_weight'), item=DROPPED)
        out.update(reg_loss_type='ghmr', ghm_mu=lb.get('mu', 0.02),
                   ghm_r_bins=lb.get('bins', 10),
                   loss_bbox_weight=lb.get('loss_weight', 10.0))
    elif t in ('L1Loss', 'SmoothL1Loss'):
        _check_keys(t, lb, ('type', 'beta'), {'loss_weight': 1.0}, DROPPED)
    elif t == 'BalancedL1Loss':
        raise not_ported('RetinaNet BalancedL1Loss (Libra)', 8)
    else:
        raise not_ported(f'RetinaNet loss_bbox {t}', 6)
    return out


RETINA_KEYS = ('type', 'num_classes', 'in_channels', 'stacked_convs',
               'feat_channels', 'anchor_generator', 'bbox_coder', 'loss_cls',
               'loss_bbox')
FREE_ANCHOR_KEYS = ('pre_anchor_topk', 'bbox_thr', 'gamma', 'alpha')


def build_ga_retinanet(hc: dict, train_cfg: dict, test_cfg: dict, modules):
    """GA-RetinaNet: RetinaNet over a ``GARetinaHead`` (JAX ``builder.py:
    658-697``). JAX decodes the guided anchors and the boxes with
    ``anchor_coder``'s stds and reads no ``bbox_coder``, which is accepted
    only as the same coder; the focal losses are JAX's fixed gamma 2, alpha
    0.25."""
    from .guided_anchor import GARetinaHead, GARetinaNet
    _check_keys('GARetinaHead', hc, GA_HEAD_KEYS + ('num_classes',
                                                    'stacked_convs'),
                item=DROPPED)
    coder = _cfg(hc.get('anchor_coder'))
    _check_keys('GARetinaHead anchor_coder', coder, ('target_stds',), dict(
        type='DeltaXYWHBBoxCoder', target_means=[0., 0., 0., 0.],
        clip_border=True), DROPPED)
    stds = tuple(coder.get('target_stds', (1., 1., 1., 1.)))
    _check_keys('GARetinaHead bbox_coder', _cfg(hc.get('bbox_coder')), (),
                dict(coder, target_stds=list(stds)), DROPPED)
    losses = ga_losses(hc, FOCAL)
    tr = _cfg(train_cfg)
    a = _cfg(tr.get('assigner'))
    _check_keys('GA-RetinaNet assigner', a, ('pos_iou_thr', 'neg_iou_thr',
                                             'min_pos_iou'),
                dict(type='MaxIoUAssigner', ignore_iof_thr=-1,
                     gt_max_assign_all=True, match_low_quality=True),
                DROPPED)
    kw = ga_train_cfg(tr, ('assigner',))
    num_classes = hc.get('num_classes', 80)
    head = GARetinaHead(num_classes, hc.get('in_channels', 256),
                        hc.get('feat_channels', 256),
                        hc.get('stacked_convs', 4), hc.get('deform_groups', 4))
    return GARetinaNet(
        bbox_head=head, **modules, num_classes=num_classes,
        **ga_anchor_cfg(hc, (8, 16, 32, 64, 128), 4), target_stds=stds,
        **kw, pos_iou_thr=a.get('pos_iou_thr', 0.5),
        neg_iou_thr=a.get('neg_iou_thr', 0.5),
        min_pos_iou=a.get('min_pos_iou', 0.0),
        smoothl1_beta=0.04 if losses['beta'] is None else losses['beta'],
        shape_beta=losses['shape_beta'],
        loc_filter_thr=hc.get('loc_filter_thr', 0.01),
        **_test_cfg(test_cfg, 0.5))


def build_retinanet(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """RetinaNet (``RetinaHead``, ``RetinaSepBNHead``), FreeAnchor
    (``FreeAnchorRetinaHead``) and GA-RetinaNet (``GARetinaHead``)."""
    hc = _cfg(cfg['bbox_head'])
    ht = hc.get('type')
    if ht == 'GARetinaHead':
        return build_ga_retinanet(hc, train_cfg, test_cfg, modules)
    if ht not in ('RetinaHead', 'RetinaSepBNHead', 'FreeAnchorRetinaHead'):
        raise not_ported(f'bbox head {ht}', HEAD_ITEMS.get(ht, 6))
    legacy = _legacy(hc)
    kw = dict(num_classes=hc.get('num_classes', 80), **_anchors(hc, legacy))
    num_anchors = (len(kw['anchor_ratios']) *
                   kw['anchor_scales_per_octave'])
    head_kw = dict(num_classes=kw['num_classes'],
                   in_channels=hc.get('in_channels', 256),
                   feat_channels=hc.get('feat_channels', 256),
                   stacked_convs=hc.get('stacked_convs', 4),
                   num_anchors=num_anchors)
    kw.update(_test_cfg(test_cfg, 0.5))
    if ht == 'FreeAnchorRetinaHead':
        if legacy:
            raise not_ported('a legacy FreeAnchor', DROPPED)
        _check_keys(ht, hc, RETINA_KEYS + FREE_ANCHOR_KEYS, item=DROPPED)
        lb = _cfg(hc.get('loss_bbox'))
        _check_keys('FreeAnchor loss_bbox', lb, ('type', 'beta',
                                                 'loss_weight'),
                    item=DROPPED)
        if lb.get('type', 'SmoothL1Loss') != 'SmoothL1Loss':
            raise not_ported(f'FreeAnchor loss_bbox {lb["type"]}', DROPPED)
        return FreeAnchor(
            bbox_head=RetinaHead(**head_kw), **modules, **kw,
            **_coder(hc, (0.1, 0.1, 0.2, 0.2)),
            pre_anchor_topk=hc.get('pre_anchor_topk', 50),
            bbox_thr=hc.get('bbox_thr', 0.6), fa_gamma=hc.get('gamma', 2.0),
            fa_alpha=hc.get('alpha', 0.5),
            smoothl1_beta=lb.get('beta', 0.11),
            loss_bbox_weight=lb.get('loss_weight', 0.75))
    if ht == 'RetinaSepBNHead':
        _check_keys(ht, hc, RETINA_KEYS + ('num_ins', 'norm_cfg'),
                    item=DROPPED)
        norm = _cfg(hc.get('norm_cfg'))
        if norm.get('type') not in ('BN', 'SyncBN') or \
                norm.get('requires_grad', True) is not True:
            raise not_ported(f'RetinaSepBNHead norm_cfg {norm} (the JAX '
                             'head has BatchNorm)', DROPPED)
        head = RetinaSepBNHead(num_ins=hc.get('num_ins', 5), **head_kw)
    else:
        _check_keys(ht, hc, RETINA_KEYS, {'conv_cfg': None,
                                          'norm_cfg': None}, DROPPED)
        head = RetinaHead(**head_kw)
    a = _train_cfg(train_cfg, 'MaxIoUAssigner',
                   ('pos_iou_thr', 'neg_iou_thr', 'min_pos_iou'))
    return RetinaNet(
        bbox_head=head, **modules, **kw, **_coder(hc, (1., 1., 1., 1.)),
        legacy=legacy, pos_iou_thr=a.get('pos_iou_thr', 0.5),
        neg_iou_thr=a.get('neg_iou_thr', 0.4),
        min_pos_iou=a.get('min_pos_iou', 0.0), **_retina_losses(hc))


def _gn(what: str, norm_cfg: dict):
    """GN's ``num_groups`` of a head's ``norm_cfg``, or None."""
    if not norm_cfg:
        return None
    if norm_cfg.get('type') != 'GN':
        raise not_ported(f'{what} norm_cfg {norm_cfg.get("type")}', DROPPED)
    _check_keys(f'{what} norm_cfg', norm_cfg, ('type', 'num_groups'),
                {'requires_grad': True}, DROPPED)
    return norm_cfg.get('num_groups', 32)


ATSS_KEYS = ('type', 'num_classes', 'in_channels', 'stacked_convs',
             'feat_channels', 'anchor_generator', 'bbox_coder')


def build_atss(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """ATSS over ``ATSSHead``: its losses are fixed in JAX's code (focal 2 /
    0.25, GIoU at weight 2, centerness BCE), so the configs' must be
    those; its head's GN is 32 groups, as JAX's."""
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'ATSSHead':
        raise not_ported(f'ATSS bbox head {hc.get("type")}', 6)
    _check_keys('ATSSHead', hc, ATSS_KEYS + (
        'loss_cls', 'loss_bbox', 'loss_centerness', 'norm_cfg'),
        item=DROPPED)
    for key, want in (('loss_cls', FOCAL), ('loss_centerness', CENTERNESS),
                      ('loss_bbox', dict(type='GIoULoss', loss_weight=2.0))):
        _check_keys(f'ATSS {key}', _cfg(hc.get(key)), (), want, DROPPED)
    if _gn('ATSSHead', _cfg(hc.get('norm_cfg')) or {'type': 'GN'}) != 32:
        raise not_ported('ATSSHead GN groups other than 32', DROPPED)
    a = _cfg(hc.get('anchor_generator'))
    _check_keys('ATSS anchor_generator', a, ('octave_base_scale', 'ratios',
                                             'strides'),
                {'type': 'AnchorGenerator', 'scales_per_octave': 1,
                 'center_offset': 0.0}, DROPPED)
    strides = tuple(a.get('strides', (8, 16, 32, 64, 128)))
    assigner = _train_cfg(train_cfg, 'ATSSAssigner', ('topk',))
    head = ATSSHead(num_classes=hc.get('num_classes', 80),
                    in_channels=hc.get('in_channels', 256),
                    feat_channels=hc.get('feat_channels', 256),
                    stacked_convs=hc.get('stacked_convs', 4),
                    num_levels=len(strides))
    return ATSS(bbox_head=head, **modules,
                num_classes=hc.get('num_classes', 80), strides=strides,
                octave_base_scale=a.get('octave_base_scale', 8),
                anchor_ratios=tuple(a.get('ratios', (1.0,))),
                **_coder(hc, (0.1, 0.1, 0.2, 0.2)),
                assigner_topk=assigner.get('topk', 9),
                **_test_cfg(test_cfg, 0.6))


FCOS_KEYS = ('type', 'num_classes', 'in_channels', 'stacked_convs',
             'feat_channels', 'strides', 'norm_cfg', 'centerness_on_reg',
             'norm_on_bbox', 'center_sampling', 'center_sample_radius',
             'regress_ranges', 'loss_cls', 'loss_bbox', 'loss_centerness',
             'dcn_on_last_conv')
# the regression losses of FCOS as JAX maps them (builder.py:1122-1126):
# IoULoss -> -log(IoU), anything else (and none) -> GIoU (3ae)
FCOS_REG = {'IoULoss': ('log_iou', {'linear': False}),
            'GIoULoss': ('giou', {})}


def build_fcos(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """FCOS over ``FCOSHead``."""
    hc = _cfg(cfg['bbox_head'])
    ht = hc.get('type')
    if ht != 'FCOSHead':
        raise not_ported(f'FCOS bbox head {ht}', HEAD_ITEMS.get(ht, 6))
    _check_keys('FCOSHead', hc, FCOS_KEYS, {'conv_bias': 'auto',
                                            'conv_cfg': None}, DROPPED)
    for key, want in (('loss_cls', FOCAL), ('loss_centerness', CENTERNESS)):
        _check_keys(f'FCOS {key}', _cfg(hc.get(key)), (), want, DROPPED)
    lb = _cfg(hc.get('loss_bbox'))
    if lb.get('type', 'GIoULoss') not in FCOS_REG:
        raise not_ported(f'FCOS loss_bbox {lb["type"]}', DROPPED)
    mode, fixed = FCOS_REG[lb.get('type', 'GIoULoss')]
    _check_keys('FCOS loss_bbox', lb, ('type',), dict(fixed, loss_weight=1.0),
                DROPPED)
    _train_cfg(train_cfg)
    strides = tuple(hc.get('strides', (8, 16, 32, 64, 128)))
    head = FCOSHead(num_classes=hc.get('num_classes', 80),
                    in_channels=hc.get('in_channels', 256),
                    feat_channels=hc.get('feat_channels', 256),
                    stacked_convs=hc.get('stacked_convs', 4),
                    strides=strides,
                    gn_groups=_gn('FCOSHead', _cfg(hc.get('norm_cfg'))),
                    centerness_on_reg=hc.get('centerness_on_reg', False),
                    norm_on_bbox=hc.get('norm_on_bbox', False),
                    dcn_on_last_conv=bool(hc.get('dcn_on_last_conv', False)))
    return FCOS(bbox_head=head, **modules,
                num_classes=hc.get('num_classes', 80),
                regress_ranges=tuple(tuple(r) for r in hc.get(
                    'regress_ranges', ((-1, 64), (64, 128), (128, 256),
                                       (256, 512), (512, INF)))),
                center_sampling=hc.get('center_sampling', False),
                center_sample_radius=hc.get('center_sample_radius', 1.5),
                reg_loss_mode=mode, **_test_cfg(test_cfg, 0.5))


def build_single_stage(t: str, cfg: dict, train_cfg: dict, test_cfg: dict,
                       modules: Dict) -> Tuple:
    """The single-stage detector of type ``t`` over the built ``modules``
    (backbone and neck)."""
    _check_keys(t, cfg, ('backbone', 'neck', 'bbox_head'))
    build = {'ATSS': build_atss, 'FCOS': build_fcos}.get(t, build_retinanet)
    return build(cfg, train_cfg, test_cfg, modules)
