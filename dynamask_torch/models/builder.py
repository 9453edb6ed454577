"""Build the port's detector from a reference-schema config (port of the
parts of ``dynamask_tpu/models/builder.py`` (the RefineMask branch
:451-494) and ``dynamask_tpu/models/dynamask_roi_head.py:
build_dynamask_roi_head`` (:422-464) that the Mask R-CNN, DynaMask and
RefineMask configs use).

Modules are created on the ``meta`` device, materialised on the target
device, filled from an explicit ``torch.Generator``, put in eval mode and
converted to ``channels_last`` (convs then run through cuDNN in NHWC and the
kernels read the maps without a copy).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.device import resolve_device
from ..utils.registry import BACKBONES, DETECTORS, NECKS
from .bbox_head import Shared2FCBBoxHead
from .dynamask_head import DynaMaskHead, MaskPre
from .dynamask_roi_head import DynaMaskRoIHead
from .fcn_mask_head import FCNMaskHead
from .layers import init_weights
from .refine_mask_head import (RefineMaskHead, RefineRoIHead,
                               SimpleRefineMaskHead, SimpleRefineRoIHead)
from .roi_head import StandardRoIHead
from .rpn_head import RPNHead

# the registered modules must be imported for their registry entries
from . import detectors, fpn, resnet  # noqa: F401


def _cfg(d) -> dict:
    return dict(d) if d else {}


def _check_sampling(stage: str, assigner: dict, sampler: dict) -> None:
    """The port has the sampling forms the configs use; refuse others."""
    if (sampler.get('type', 'RandomSampler') != 'RandomSampler' or
            sampler.get('neg_pos_ub', -1) != -1 or
            not assigner.get('gt_max_assign_all', True) or
            assigner.get('ignore_iof_thr', -1) > 0):
        raise NotImplementedError(f'{stage} sampling {assigner} {sampler}')


def build_backbone(cfg: dict):
    cfg = _cfg(cfg)
    cfg['out_indices'] = tuple(cfg.get('out_indices', (0, 1, 2, 3)))
    return BACKBONES.build(cfg)


def build_neck(cfg: dict):
    cfg = _cfg(cfg)
    cfg['in_channels'] = tuple(cfg['in_channels'])
    return NECKS.build(cfg)


def build_rpn_head(cfg: dict):
    cfg = _cfg(cfg)
    if cfg.get('type') != 'RPNHead':
        raise KeyError(f'unsupported rpn head {cfg.get("type")}')
    anchor_cfg = _cfg(cfg.get('anchor_generator'))
    num_anchors = (len(anchor_cfg.get('scales', [8])) *
                   len(anchor_cfg.get('ratios', [0.5, 1.0, 2.0])))
    head = RPNHead(cfg.get('in_channels', 256), cfg.get('feat_channels', 256),
                   num_anchors)
    return head, anchor_cfg, _cfg(cfg.get('bbox_coder'))


def build_fcn_mask_head(mhc: dict) -> FCNMaskHead:
    """``FCNMaskHead`` from its config (JAX ``builder.py:366-379``)."""
    norm = _cfg(mhc.get('norm_cfg')).get('type')
    return FCNMaskHead(
        num_convs=mhc.get('num_convs', 4),
        in_channels=mhc.get('in_channels', 256),
        conv_out_channels=mhc.get('conv_out_channels', 256),
        num_classes=mhc.get('num_classes', 80),
        class_agnostic=mhc.get('class_agnostic', False),
        upsample_type=_cfg(mhc.get('upsample_cfg')).get('type', 'deconv'),
        norm=norm.lower() if norm else None)


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


ROI_HEADS = ('StandardRoIHead', 'DynaMaskRoIHead', *REFINE_HEADS)


def build_roi_head(cfg: dict, train_cfg: dict, test_cfg: dict):
    """The RoI head of ``cfg``: ``StandardRoIHead`` with an
    ``FCNMaskHead`` (Mask R-CNN), ``DynaMaskRoIHead`` with a
    ``DynaMaskHead`` (DynaMask) or ``RefineRoIHead`` /
    ``SimpleRefineRoIHead`` with a ``RefineMaskHead`` /
    ``SimpleRefineMaskHead`` (RefineMask), on one Shared2FC box branch."""
    cfg = _cfg(cfg)
    t = cfg.pop('type')
    if t not in ROI_HEADS:
        raise KeyError(f'unsupported roi head {t}: the port has '
                       f'{", ".join(ROI_HEADS)}')
    head_cfg = _cfg(cfg['bbox_head'])
    if head_cfg.pop('type') != 'Shared2FCBBoxHead':
        raise KeyError('unsupported bbox head: the port has Shared2FC only')
    bbox_head = Shared2FCBBoxHead(
        num_classes=head_cfg.get('num_classes', 80),
        in_channels=head_cfg.get('in_channels', 256),
        roi_feat_size=head_cfg.get('roi_feat_size', 7),
        fc_out_channels=head_cfg.get('fc_out_channels', 1024),
        reg_class_agnostic=head_cfg.get('reg_class_agnostic', False))
    coder = _cfg(head_cfg.get('bbox_coder'))
    rcnn_train = _cfg(_cfg(train_cfg).get('rcnn'))
    assigner = _cfg(rcnn_train.get('assigner'))
    sampler = _cfg(rcnn_train.get('sampler'))
    _check_sampling('rcnn', assigner, sampler)
    bbox_extractor = _cfg(cfg.get('bbox_roi_extractor'))
    mask_extractor = _cfg(cfg.get('mask_roi_extractor'))
    rcnn_test = _cfg(_cfg(test_cfg).get('rcnn'))
    nms_cfg = _cfg(rcnn_test.get('nms'))
    if nms_cfg.get('type', 'nms') != 'nms':
        raise NotImplementedError(f'test nms type {nms_cfg["type"]}')
    common = dict(
        bbox_head=bbox_head,
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
        loss_cls_weight=_cfg(head_cfg.get('loss_cls')).get('loss_weight',
                                                            1.0),
        loss_bbox_weight=_cfg(head_cfg.get('loss_bbox')).get('loss_weight',
                                                              1.0))
    mhc = _cfg(cfg['mask_head'])
    mt = mhc.pop('type')
    if (t, mt) == ('DynaMaskRoIHead', 'DynaMaskHead'):
        return build_dynamask_roi_head(cfg, mhc, common, rcnn_train)
    if (t, mt) == ('StandardRoIHead', 'FCNMaskHead'):
        return StandardRoIHead(
            mask_head=build_fcn_mask_head(mhc), loss_mask_weight=_cfg(
                mhc.get('loss_mask')).get('loss_weight', 1.0), **common)
    if t in REFINE_HEADS and mt in REFINE_MASK_HEADS:
        return build_refine_roi_head(t, mt, mhc, common, mask_extractor.get(
            'out_channels', 256))
    raise KeyError(f'unsupported mask head {mt} under {t}: the port has '
                   'FCNMaskHead under StandardRoIHead, DynaMaskHead under '
                   'DynaMaskRoIHead, and RefineMaskHead or '
                   'SimpleRefineMaskHead under RefineRoIHead or '
                   'SimpleRefineRoIHead')


def build_detector(model_cfg: dict, train_cfg: Optional[dict] = None,
                   test_cfg: Optional[dict] = None, device=None,
                   seed: int = 0, init_std: Optional[float] = None):
    """The detector of ``model_cfg`` on ``device`` (default ``cuda``; raises
    without a GPU unless ``device='cpu'``), its weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (see
    :func:`dynamask_torch.models.layers.init_weights` for ``init_std``)."""
    dev = resolve_device(device)
    cfg = _cfg(model_cfg)
    t = cfg.pop('type')
    cfg.pop('pretrained', None)
    if t != 'MaskRCNN':
        raise KeyError(f'unsupported detector {t}: the port has MaskRCNN')
    with torch.device('meta'):
        backbone = build_backbone(cfg['backbone'])
        neck = build_neck(cfg['neck'])
        rpn_head, anchor_cfg, rpn_coder = build_rpn_head(cfg['rpn_head'])
        roi_head = build_roi_head(cfg['roi_head'], train_cfg, test_cfg)
    rpn_test = _cfg(_cfg(test_cfg).get('rpn'))
    # max_num and nms_thr come from train_cfg.rpn_proposal, as in the JAX
    # builder (dynamask_tpu/models/builder.py:1208-1211)
    rpn_proposal = _cfg(_cfg(train_cfg).get('rpn_proposal'))
    rpn_train = _cfg(_cfg(train_cfg).get('rpn'))
    rpn_assigner = _cfg(rpn_train.get('assigner'))
    rpn_sampler = _cfg(rpn_train.get('sampler'))
    _check_sampling('rpn', rpn_assigner, rpn_sampler)
    rpn_losses = _cfg(model_cfg['rpn_head'])
    det = DETECTORS.build(dict(
        type=t, backbone=backbone, neck=neck, rpn_head=rpn_head,
        roi_head=roi_head,
        anchor_scales=tuple(anchor_cfg.get('scales', (8,))),
        anchor_ratios=tuple(anchor_cfg.get('ratios', (0.5, 1.0, 2.0))),
        anchor_strides=tuple(anchor_cfg.get('strides', (4, 8, 16, 32, 64))),
        rpn_target_means=tuple(rpn_coder.get('target_means',
                                             (0., 0., 0., 0.))),
        rpn_target_stds=tuple(rpn_coder.get('target_stds', (1., 1., 1., 1.))),
        rpn_nms_pre_test=rpn_test.get('nms_pre', 1000),
        rpn_max_num=rpn_proposal.get('max_num', 1000),
        rpn_nms_thr=rpn_proposal.get('nms_thr', 0.7),
        rpn_nms_pre_train=rpn_proposal.get('nms_pre', 2000),
        rpn_pos_iou_thr=rpn_assigner.get('pos_iou_thr', 0.7),
        rpn_neg_iou_thr=rpn_assigner.get('neg_iou_thr', 0.3),
        rpn_min_pos_iou=rpn_assigner.get('min_pos_iou', 0.3),
        rpn_num_samples=rpn_sampler.get('num', 256),
        rpn_pos_fraction=rpn_sampler.get('pos_fraction', 0.5),
        rpn_cls_weight=_cfg(rpn_losses.get('loss_cls')).get('loss_weight',
                                                             1.0),
        rpn_bbox_weight=_cfg(rpn_losses.get('loss_bbox')).get('loss_weight',
                                                              1.0)))
    det = det.to_empty(device=dev)
    det.backbone.freeze_stages()
    init_weights(det, torch.Generator(device=dev).manual_seed(seed), init_std)
    if init_std is None and isinstance(det.roi_head, DynaMaskRoIHead):
        with torch.no_grad():
            det.roi_head.mask_head.loss_func.detail_target.fuse_kernel.copy_(
                torch.tensor([0.7, 0.3]).reshape(1, 2, 1, 1))
    return det.eval().to(memory_format=torch.channels_last)
