"""Build the single-stage detectors from a reference-schema config (port
of the parts of ``dynamask_tpu/models/builder.py`` that build them:
``build_single_stage`` :614-770 for RetinaNet, its GHM, legacy v1,
SepBN, Libra (balanced L1) and PISA forms, FreeAnchor and GA-RetinaNet
(:658-697), ``build_ssd`` :772-800 for SSD and PISA-SSD, and
``build_detector``'s ATSS :886-915, RepPoints :916-960, FoveaBox
:962-995, FSAF :997-1028, GFL :1051-1080 and FCOS with NAS-FCOS
:1082-1127).

As in ``models/builder.py``, every key that changes the model is read or
refused, naming the ROADMAP.md item where its port is queued or the JAX
fault that fixes it: the keys the JAX builder drops are accepted only at
the value JAX computes with (ROADMAP.md queue 3, 3w), but for the faults
the configs rely on, which the port reproduces: GHM's ``momentum``
(3ab: the losses are momentum-free), RetinaNet's ``SmoothL1Loss`` (3af:
it regresses with L1, whatever the type; PISA's RetinaNet too), SSD's
assigner's ``gt_max_assign_all=False`` (3bm: every anchor that ties a GT's
best IoU is claimed) and the NAS-FPN file's ``RetinaSepBNHead``
``norm_cfg=None`` (3bo: the JAX head has BatchNorm).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .atss import ATSS, ATSSHead
from .builder import (DROPPED, GA_HEAD_KEYS, UNQUEUED, _cfg, _check_keys,
                      ga_anchor_cfg, ga_losses, ga_train_cfg, not_ported,
                      pisa_cfg)
from .fcos import FCOS, FCOSHead, INF
from .freeanchor import FreeAnchor
from .single_stage import RetinaHead, RetinaNet, RetinaSepBNHead

SINGLE_STAGE = ('RetinaNet', 'SingleStageDetector', 'ATSS', 'FCOS', 'NASFCOS',
                'GFL', 'FSAF', 'FOVEA', 'RepPointsDetector')
SSD_HEADS = ('SSDHead', 'PISASSDHead')
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
        raise not_ported(f'assigner {a["type"]} of a single-stage head',
                         UNQUEUED)
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
        # Libra RetinaNet: JAX fixes beta 0.11, alpha 0.5 and gamma 1.5
        # (single_stage.py:215-222) and reads the weight
        _check_keys(t, lb, ('type', 'loss_weight'),
                    {'alpha': 0.5, 'gamma': 1.5, 'beta': 0.11}, DROPPED)
        if lb.get('beta', 1.0) != 0.11:
            raise not_ported('RetinaNet BalancedL1Loss beta other than the '
                             '0.11 JAX applies', DROPPED)
        out.update(reg_loss_type='balanced_l1',
                   loss_bbox_weight=lb.get('loss_weight', 1.0))
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
    if ht not in ('RetinaHead', 'RetinaSepBNHead', 'FreeAnchorRetinaHead',
                  'PISARetinaHead'):
        raise not_ported(f'bbox head {ht}', 6)
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
    if ht == 'PISARetinaHead':
        return build_pisa_retinanet(hc, train_cfg, head_kw, kw, legacy,
                                    modules)
    if ht == 'RetinaSepBNHead':
        _check_keys(ht, hc, RETINA_KEYS + ('num_ins', 'norm_cfg'),
                    item=DROPPED)
        # norm_cfg=None (the NAS-FPN file's) keeps JAX's BatchNorm (3bo)
        norm = _cfg(hc.get('norm_cfg')) or {'type': 'BN'}
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


def build_pisa_retinanet(hc: dict, train_cfg: dict, head_kw: dict, kw: dict,
                         legacy: bool, modules):
    """PISA RetinaNet (JAX ``builder.py:741-750``): a ``RetinaHead``,
    the focal loss's gamma and alpha, CARL's beta from ``loss_bbox`` (the
    box loss is L1 whatever its type, 3af), ``train_cfg``'s ``isr`` and
    ``carl``. JAX builds it without the legacy anchors."""
    from .pisa import PISARetinaNet
    if legacy:
        raise not_ported('a legacy PISA RetinaNet (JAX builds it without '
                         'the legacy anchors)', DROPPED)
    _check_keys('PISARetinaHead', hc, RETINA_KEYS,
                {'conv_cfg': None, 'norm_cfg': None}, DROPPED)
    lc = _cfg(hc.get('loss_cls')) or dict(FOCAL)
    _check_keys('PISA FocalLoss', lc, ('type', 'gamma', 'alpha'),
                {'use_sigmoid': True, 'loss_weight': 1.0}, DROPPED)
    if lc.get('type') != 'FocalLoss':
        raise not_ported(f'PISA RetinaNet loss_cls {lc.get("type")}', DROPPED)
    lb = _cfg(hc.get('loss_bbox'))
    _check_keys('PISA loss_bbox', lb, ('type', 'beta'), {'loss_weight': 1.0},
                DROPPED)
    if lb.get('type') not in ('SmoothL1Loss', 'L1Loss'):
        raise not_ported(f'PISA RetinaNet loss_bbox {lb.get("type")}',
                         DROPPED)
    tr = _cfg(train_cfg)
    a = _train_cfg({k: v for k, v in tr.items() if k not in ('isr', 'carl')},
                   'MaxIoUAssigner', ('pos_iou_thr', 'neg_iou_thr',
                                      'min_pos_iou'))
    return PISARetinaNet(
        bbox_head=RetinaHead(**head_kw), **modules, **kw,
        **_coder(hc, (1., 1., 1., 1.)), pos_iou_thr=a.get('pos_iou_thr', 0.5),
        neg_iou_thr=a.get('neg_iou_thr', 0.4),
        min_pos_iou=a.get('min_pos_iou', 0.0),
        focal_gamma=lc.get('gamma', 2.0), focal_alpha=lc.get('alpha', 0.25),
        carl_beta=lb.get('beta', 0.11), **pisa_cfg(tr))


# SSDVGG's keys that JAX reads (``input_size``, ``depth`` at 16) and the
# others at the values it computes with (``builder.py:774-777``)
SSDVGG_FIXED = dict(with_last_pool=False, ceil_mode=True, out_indices=(3, 4),
                    out_feature_indices=(22, 34), l2_norm_scale=20)
SSD_TRAIN_KEYS = ('assigner', 'smoothl1_beta', 'neg_pos_ratio')
SSD512 = ('ROADMAP.md queue 3, 3bi: the JAX SSDVGG gives 6 levels on a 512 '
          'canvas against the 7 of the config\'s anchors, and raises')


def build_ssd(cfg: dict, train_cfg: dict, test_cfg: dict):
    """SSD and PISA-SSD (JAX ``build_ssd``, ``builder.py:772-800``):
    ``SSDVGG`` at its input size (300; 512 refused, 3bi), an ``SSDHead`` /
    ``PISASSDHead`` of ``2 + 2 * len(ratios)`` anchors a level over the
    VGG's widths, the SSD anchors (legacy where the generator or the coder
    says so), the assigner, ``smoothl1_beta`` and ``neg_pos_ratio``; PISA's
    ``isr`` and ``carl``. The assigner's ``gt_max_assign_all=False``, which
    JAX drops, is computed as JAX computes it (3bm)."""
    from .pisa import PISASSD
    from .ssd import SSD, SSDVGG, SSDHead
    _check_keys('SSD', cfg, ('backbone', 'neck', 'bbox_head'))
    bc = _cfg(cfg['backbone'])
    if bc.get('type') != 'SSDVGG':
        raise not_ported(f'an SSD head over {bc.get("type")}', 'no item')
    _check_keys('SSDVGG', bc, ('type', 'input_size'),
                dict(SSDVGG_FIXED, depth=16), DROPPED)
    size = bc.get('input_size', 300)
    if size != 300:
        raise not_ported(f'SSD at input_size {size}', SSD512)
    backbone = SSDVGG(size)
    hc = _cfg(cfg['bbox_head'])
    ht = hc.get('type')
    # JAX's head takes the VGG's widths whatever the config says
    if tuple(hc.pop('in_channels', backbone.out_channels)) != \
            backbone.out_channels:
        raise not_ported(f'{ht} in_channels other than the VGG\'s '
                         f'{backbone.out_channels}', DROPPED)
    _check_keys(ht, hc, ('type', 'num_classes', 'anchor_generator',
                         'bbox_coder'), item=DROPPED)
    a = _cfg(hc.get('anchor_generator'))
    _check_keys('SSD anchor_generator', a, (
        'type', 'basesize_ratio_range', 'strides', 'ratios'),
        {'scale_major': False, 'input_size': size}, DROPPED)
    coder = _cfg(hc.get('bbox_coder'))
    _check_keys('SSD bbox_coder', coder, ('type', 'target_means',
                                          'target_stds'),
                {'clip_border': True}, DROPPED)
    legacy = _legacy(hc)
    for what, got, want in (
            ('anchor generator', a.get('type', 'SSDAnchorGenerator'),
             'SSDAnchorGenerator'),
            ('bbox coder', coder.get('type', 'DeltaXYWHBBoxCoder'),
             'DeltaXYWHBBoxCoder')):
        if got != ('Legacy' if legacy else '') + want:
            raise not_ported(f'SSD {what} {got}', DROPPED)
    ratios = tuple(tuple(r) for r in a.get(
        'ratios', ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))))
    strides = tuple(a.get('strides', (8, 16, 32, 64, 100, 300)))
    if not len(ratios) == len(strides) == len(backbone.out_channels):
        raise not_ported(f'SSD anchors on {len(strides)} levels over the '
                         f'VGG\'s {len(backbone.out_channels)}', DROPPED)
    num_classes = hc.get('num_classes', 80)
    head = SSDHead(num_classes, backbone.out_channels,
                   [2 + 2 * len(r) for r in ratios])
    tr = _cfg(train_cfg)
    pisa = ht == 'PISASSDHead'
    _check_keys('SSD train_cfg', tr, SSD_TRAIN_KEYS + (
        ('isr', 'carl') if pisa else ()),
        {'allowed_border': -1, 'pos_weight': -1, 'debug': False}, DROPPED)
    asg = _cfg(tr.get('assigner'))
    _check_keys('SSD assigner', asg, ('type', 'pos_iou_thr', 'neg_iou_thr',
                                      'min_pos_iou', 'gt_max_assign_all'),
                {'ignore_iof_thr': -1, 'match_low_quality': True}, DROPPED)
    if asg.get('type', 'MaxIoUAssigner') != 'MaxIoUAssigner':
        raise not_ported(f'SSD assigner {asg["type"]}', DROPPED)
    tc = _test_cfg(test_cfg, 0.45)
    kw = dict(num_classes=num_classes, input_size=size, strides=strides,
              ratios=ratios, basesize_ratio_range=tuple(
                  a.get('basesize_ratio_range', (0.15, 0.9))),
              target_means=tuple(coder.get('target_means', (0., 0., 0., 0.))),
              target_stds=tuple(coder.get('target_stds',
                                          (0.1, 0.1, 0.2, 0.2))),
              pos_iou_thr=asg.get('pos_iou_thr', 0.5),
              neg_iou_thr=asg.get('neg_iou_thr', 0.5),
              min_pos_iou=asg.get('min_pos_iou', 0.2),
              neg_pos_ratio=tr.get('neg_pos_ratio', 3),
              smoothl1_beta=tr.get('smoothl1_beta', 1.0),
              nms_pre=tc['nms_pre'],
              score_thr=_cfg(test_cfg).get('score_thr', 0.02),
              nms_iou_thr=tc['nms_iou_thr'],
              max_per_img=_cfg(test_cfg).get('max_per_img', 200))
    if not pisa:
        return SSD(backbone, head, legacy=legacy, **kw)
    if legacy:
        raise not_ported('a legacy PISA-SSD (JAX builds it without the '
                         'legacy anchors)', DROPPED)
    return PISASSD(backbone, head, **pisa_cfg(tr), **kw)


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


# the FCOSHead keys JAX does not read for a NASFCOSHead (builder.py:
# 1090-1096), accepted at mmdet's defaults
NAS_HEAD_DEFAULTS = dict(stacked_convs=4, centerness_on_reg=False,
                         norm_on_bbox=False, dcn_on_last_conv=False,
                         conv_bias='auto', conv_cfg=None)


def build_fcos(cfg: dict, train_cfg: dict, test_cfg: dict, modules,
               nas: bool = False):
    """FCOS over ``FCOSHead``; NAS-FCOS (``nas``) over ``FCOSHead`` or the
    searched ``NASFCOSHead``. Neither JAX nor mmdet's FCOS head reads a
    ``train_cfg.assigner`` (the NAS-FCOS configs name a ``MaxIoUAssigner``):
    it is accepted for NAS-FCOS and changes nothing."""
    hc = _cfg(cfg['bbox_head'])
    ht = hc.get('type')
    if ht == 'NASFCOSHead' and nas:
        from .nasfcos import NASFCOSHead
        _check_keys('NASFCOSHead', hc, [k for k in FCOS_KEYS
                                         if k not in NAS_HEAD_DEFAULTS],
                    NAS_HEAD_DEFAULTS, DROPPED)
        gn = _gn('NASFCOSHead', _cfg(hc.get('norm_cfg')) or {'type': 'GN'})
        head = NASFCOSHead(num_classes=hc.get('num_classes', 80),
                           in_channels=hc.get('in_channels', 256),
                           feat_channels=hc.get('feat_channels', 256),
                           strides=tuple(hc.get('strides',
                                                (8, 16, 32, 64, 128))),
                           gn_groups=gn)
    elif ht != 'FCOSHead':
        raise not_ported(f'FCOS bbox head {ht}', 6)
    else:
        head = None
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
    if nas and 'assigner' in _cfg(train_cfg):
        _train_cfg(train_cfg, 'MaxIoUAssigner',
                   ('pos_iou_thr', 'neg_iou_thr', 'min_pos_iou'))
    else:
        _train_cfg(train_cfg)
    strides = tuple(hc.get('strides', (8, 16, 32, 64, 128)))
    head = head or FCOSHead(
        num_classes=hc.get('num_classes', 80),
        in_channels=hc.get('in_channels', 256),
        feat_channels=hc.get('feat_channels', 256),
        stacked_convs=hc.get('stacked_convs', 4), strides=strides,
        gn_groups=_gn('FCOSHead', _cfg(hc.get('norm_cfg'))),
        centerness_on_reg=hc.get('centerness_on_reg', False),
        norm_on_bbox=hc.get('norm_on_bbox', False),
        dcn_on_last_conv=bool(hc.get('dcn_on_last_conv', False)))
    if nas:
        from .nasfcos import NASFCOS as FCOS_
    else:
        FCOS_ = FCOS
    return FCOS_(bbox_head=head, **modules,
                num_classes=hc.get('num_classes', 80),
                regress_ranges=tuple(tuple(r) for r in hc.get(
                    'regress_ranges', ((-1, 64), (64, 128), (128, 256),
                                       (256, 512), (512, INF)))),
                center_sampling=hc.get('center_sampling', False),
                center_sample_radius=hc.get('center_sample_radius', 1.5),
                reg_loss_mode=mode, **_test_cfg(test_cfg, 0.5))


GFL_KEYS = ('type', 'num_classes', 'in_channels', 'stacked_convs',
            'feat_channels', 'anchor_generator', 'reg_max', 'loss_cls',
            'loss_dfl', 'loss_bbox', 'norm_cfg')


def build_gfl(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """GFL over ``GFLHead`` (JAX ``builder.py:1051-1080``): QFL fixed at
    beta 2 and weight 1, DFL's and GIoU's weights read, GN 32 groups."""
    from .gfl import GFL, GFLHead
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'GFLHead':
        raise not_ported(f'GFL bbox head {hc.get("type")}', 6)
    _check_keys('GFLHead', hc, GFL_KEYS, item=DROPPED)
    _check_keys('GFL loss_cls', _cfg(hc.get('loss_cls')), (), dict(
        type='QualityFocalLoss', use_sigmoid=True, beta=2.0, loss_weight=1.0),
        DROPPED)
    dfl, giou = _cfg(hc.get('loss_dfl')), _cfg(hc.get('loss_bbox'))
    _check_keys('GFL loss_dfl', dfl, ('loss_weight',),
                {'type': 'DistributionFocalLoss'}, DROPPED)
    _check_keys('GFL loss_bbox', giou, ('loss_weight',),
                {'type': 'GIoULoss'}, DROPPED)
    if _gn('GFLHead', _cfg(hc.get('norm_cfg')) or {'type': 'GN'}) != 32:
        raise not_ported('GFLHead GN groups other than 32', DROPPED)
    a = _cfg(hc.get('anchor_generator'))
    _check_keys('GFL anchor_generator', a, ('octave_base_scale', 'ratios',
                                            'strides'),
                {'type': 'AnchorGenerator', 'scales_per_octave': 1,
                 'center_offset': 0.0}, DROPPED)
    strides = tuple(a.get('strides', (8, 16, 32, 64, 128)))
    reg_max = hc.get('reg_max', 16)
    assigner = _train_cfg(train_cfg, 'ATSSAssigner', ('topk',))
    head = GFLHead(num_classes=hc.get('num_classes', 80),
                   in_channels=hc.get('in_channels', 256),
                   feat_channels=hc.get('feat_channels', 256),
                   stacked_convs=hc.get('stacked_convs', 4),
                   num_levels=len(strides), reg_max=reg_max)
    return GFL(bbox_head=head, **modules,
               num_classes=hc.get('num_classes', 80), strides=strides,
               octave_base_scale=a.get('octave_base_scale', 8),
               anchor_ratios=tuple(a.get('ratios', (1.0,))), reg_max=reg_max,
               assigner_topk=assigner.get('topk', 9),
               loss_dfl_weight=dfl.get('loss_weight', 0.25),
               loss_bbox_weight=giou.get('loss_weight', 2.0),
               **_test_cfg(test_cfg, 0.6))


FSAF_KEYS = ('type', 'num_classes', 'in_channels', 'stacked_convs',
             'feat_channels', 'anchor_generator', 'bbox_coder', 'loss_cls',
             'loss_bbox')


def build_fsaf(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """FSAF over a one-anchor ``RetinaHead`` (JAX ``builder.py:997-1028``):
    JAX reads the anchors' strides alone (the anchor is the stride cell),
    the coder's normalizer, the assigner's scales and IoF; its focal loss
    is fixed at gamma 2 and alpha 0.25, its box loss ``-log IoU`` on the
    decoded boxes, so the configs' must be those."""
    from .fsaf import FSAF
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'FSAFHead':
        raise not_ported(f'FSAF bbox head {hc.get("type")}', 6)
    _check_keys('FSAFHead', hc, FSAF_KEYS, {'reg_decoded_bbox': True},
                DROPPED)
    _check_keys('FSAF loss_cls', _cfg(hc.get('loss_cls')), (), dict(
        FOCAL, reduction='none'), DROPPED)
    _check_keys('FSAF loss_bbox', _cfg(hc.get('loss_bbox')), (), dict(
        type='IoULoss', eps=1e-6, loss_weight=1.0, reduction='none'),
        DROPPED)
    a = _cfg(hc.get('anchor_generator'))
    _check_keys('FSAF anchor_generator', a, ('strides',), dict(
        type='AnchorGenerator', octave_base_scale=1, scales_per_octave=1,
        ratios=[1.0], center_offset=0.0), DROPPED)
    coder = _cfg(hc.get('bbox_coder'))
    _check_keys('FSAF bbox_coder', coder, ('normalizer',),
                {'type': 'TBLRBBoxCoder'}, DROPPED)
    assigner = _train_cfg(train_cfg, 'CenterRegionAssigner',
                          ('pos_scale', 'neg_scale', 'min_pos_iof'))
    head = RetinaHead(num_classes=hc.get('num_classes', 80),
                      in_channels=hc.get('in_channels', 256),
                      feat_channels=hc.get('feat_channels', 256),
                      stacked_convs=hc.get('stacked_convs', 4), num_anchors=1)
    return FSAF(bbox_head=head, **modules,
                num_classes=hc.get('num_classes', 80),
                strides=tuple(a.get('strides', (8, 16, 32, 64, 128))),
                tblr_normalizer=coder.get('normalizer', 4.0),
                pos_scale=assigner.get('pos_scale', 0.2),
                neg_scale=assigner.get('neg_scale', 0.2),
                min_pos_iof=assigner.get('min_pos_iof', 0.01),
                **_test_cfg(test_cfg, 0.5))


FOVEA_KEYS = ('type', 'num_classes', 'in_channels', 'feat_channels',
              'stacked_convs', 'strides', 'base_edge_list', 'scale_ranges',
              'sigma', 'with_deform', 'deform_groups', 'norm_cfg',
              'loss_cls', 'loss_bbox')


def build_fovea(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """FoveaBox over ``FoveaHead`` (JAX ``builder.py:962-995``): the focal
    loss's gamma and alpha and SmoothL1's beta and weight read."""
    from .fovea import FOVEA, FoveaHead
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'FoveaHead':
        raise not_ported(f'FOVEA bbox head {hc.get("type")}', 6)
    _check_keys('FoveaHead', hc, FOVEA_KEYS, {'conv_cfg': None}, DROPPED)
    lc, lb = _cfg(hc.get('loss_cls')) or dict(FOCAL), _cfg(hc.get('loss_bbox'))
    _check_keys('FoveaBox loss_cls', lc, ('gamma', 'alpha'), dict(
        type='FocalLoss', use_sigmoid=True, loss_weight=1.0), DROPPED)
    _check_keys('FoveaBox loss_bbox', lb, ('beta', 'loss_weight'),
                {'type': 'SmoothL1Loss'}, DROPPED)
    _train_cfg(train_cfg)
    head = FoveaHead(num_classes=hc.get('num_classes', 80),
                     in_channels=hc.get('in_channels', 256),
                     feat_channels=hc.get('feat_channels', 256),
                     stacked_convs=hc.get('stacked_convs', 4),
                     with_deform=hc.get('with_deform', False),
                     deform_groups=hc.get('deform_groups', 4),
                     gn_groups=_gn('FoveaHead', _cfg(hc.get('norm_cfg'))))
    return FOVEA(bbox_head=head, **modules,
                 num_classes=hc.get('num_classes', 80),
                 strides=tuple(hc.get('strides', (8, 16, 32, 64, 128))),
                 base_edge_list=tuple(hc.get('base_edge_list',
                                             (16, 32, 64, 128, 256))),
                 scale_ranges=tuple(tuple(r) for r in hc.get(
                     'scale_ranges', ((8, 32), (16, 64), (32, 128),
                                      (64, 256), (128, 512)))),
                 sigma=hc.get('sigma', 0.4), focal_gamma=lc.get('gamma', 2.0),
                 focal_alpha=lc.get('alpha', 0.25),
                 smoothl1_beta=lb.get('beta', 0.11),
                 loss_bbox_weight=lb.get('loss_weight', 1.0),
                 **_test_cfg(test_cfg, 0.5))


REPPOINTS_KEYS = ('type', 'num_classes', 'in_channels', 'feat_channels',
                  'point_feat_channels', 'stacked_convs', 'num_points',
                  'gradient_mul', 'point_strides', 'point_base_scale',
                  'norm_cfg', 'loss_cls', 'loss_bbox_init',
                  'loss_bbox_refine', 'use_grid_points', 'transform_method',
                  'moment_mul')


def _stage_cfg(train_cfg: dict, stage: str, assigner_type: str, keys,
               fixed=None) -> dict:
    """RepPoints' ``train_cfg.init`` / ``.refine``: its assigner (of
    ``assigner_type``, ``keys`` read, ``fixed`` at JAX's values) and the
    keys mmdet reads at their defaults."""
    c = _cfg(_cfg(train_cfg).get(stage))
    _check_keys(f'RepPoints train_cfg.{stage}', c, ('assigner',),
                {'allowed_border': -1, 'pos_weight': -1, 'debug': False},
                DROPPED)
    a = _cfg(c.get('assigner'))
    _check_keys(f'RepPoints {stage} assigner', a, keys, dict(
        fixed or {}, type=assigner_type), DROPPED)
    return a


def build_reppoints(cfg: dict, train_cfg: dict, test_cfg: dict, modules):
    """RepPoints over ``RepPointsHead`` (JAX ``builder.py:916-960``): the
    focal loss fixed at gamma 2 and alpha 0.25, SmoothL1's beta read from
    ``loss_bbox_init`` alone (``loss_bbox_refine``'s is accepted only at the
    same value), GN on both towers at 32 groups or none, the refine
    assigner's ``min_pos_iou`` at 0."""
    from .reppoints import RepPointsDetector, RepPointsHead
    _check_keys('RepPointsDetector train_cfg', _cfg(train_cfg),
                ('init', 'refine'), item=DROPPED)
    hc = _cfg(cfg['bbox_head'])
    if hc.get('type') != 'RepPointsHead':
        raise not_ported(f'RepPoints bbox head {hc.get("type")}', 6)
    _check_keys('RepPointsHead', hc, REPPOINTS_KEYS, {'conv_cfg': None},
                DROPPED)
    _check_keys('RepPoints loss_cls', _cfg(hc.get('loss_cls')), (), FOCAL,
                DROPPED)
    init = _cfg(hc.get('loss_bbox_init'))
    _check_keys('RepPoints loss_bbox_init', init, ('beta', 'loss_weight'),
                {'type': 'SmoothL1Loss'}, DROPPED)
    beta = init.get('beta', 1.0 / 9.0)
    refine = _cfg(hc.get('loss_bbox_refine'))
    _check_keys('RepPoints loss_bbox_refine', refine, ('loss_weight',),
                {'type': 'SmoothL1Loss', 'beta': beta}, DROPPED)
    norm = _cfg(hc.get('norm_cfg'))
    if norm and _gn('RepPointsHead', norm) != 32:
        raise not_ported('RepPointsHead GN groups other than 32', DROPPED)
    if hc.get('transform_method', 'moment') not in ('moment', 'minmax',
                                                     'partial_minmax'):
        raise not_ported(f'RepPoints transform {hc["transform_method"]}',
                         DROPPED)
    ia = _stage_cfg(train_cfg, 'init', 'PointAssigner', ('scale', 'pos_num'))
    ra = _stage_cfg(train_cfg, 'refine', 'MaxIoUAssigner',
                    ('pos_iou_thr', 'neg_iou_thr'),
                    {'min_pos_iou': 0, 'ignore_iof_thr': -1})
    num_classes = hc.get('num_classes', 80)
    num_points = hc.get('num_points', 9)
    base = hc.get('point_base_scale', 4)
    head = RepPointsHead(num_classes=num_classes,
                         in_channels=hc.get('in_channels', 256),
                         feat_channels=hc.get('feat_channels', 256),
                         point_feat_channels=hc.get('point_feat_channels',
                                                    256),
                         stacked_convs=hc.get('stacked_convs', 3),
                         num_points=num_points,
                         gradient_mul=hc.get('gradient_mul', 0.1),
                         gn_groups=32 if norm else None,
                         use_grid_points=hc.get('use_grid_points', False),
                         point_base_scale=base)
    return RepPointsDetector(
        bbox_head=head, **modules, num_classes=num_classes,
        num_points=num_points,
        point_strides=tuple(hc.get('point_strides', (8, 16, 32, 64, 128))),
        point_base_scale=base, moment_mul=hc.get('moment_mul', 0.01),
        transform_method=hc.get('transform_method', 'moment'),
        init_assign_scale=ia.get('scale', 4),
        init_pos_num=ia.get('pos_num', 1),
        refine_pos_iou=ra.get('pos_iou_thr', 0.5),
        refine_neg_iou=ra.get('neg_iou_thr', 0.4),
        loss_init_weight=init.get('loss_weight', 0.5),
        loss_refine_weight=refine.get('loss_weight', 1.0),
        smoothl1_beta=beta, **_test_cfg(test_cfg, 0.5))


def build_single_stage(t: str, cfg: dict, train_cfg: dict, test_cfg: dict,
                       modules: Dict) -> Tuple:
    """The single-stage detector of type ``t`` over the built ``modules``
    (backbone and neck)."""
    _check_keys(t, cfg, ('backbone', 'neck', 'bbox_head'))
    if t == 'NASFCOS':
        return build_fcos(cfg, train_cfg, test_cfg, modules, nas=True)
    build = {'ATSS': build_atss, 'FCOS': build_fcos, 'GFL': build_gfl,
             'FSAF': build_fsaf, 'FOVEA': build_fovea,
             'RepPointsDetector': build_reppoints}.get(t, build_retinanet)
    return build(cfg, train_cfg, test_cfg, modules)
