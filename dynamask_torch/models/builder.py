"""Build the port's detector from a reference-schema config (port of the
parts of ``dynamask_tpu/models/builder.py`` and
``dynamask_tpu/models/dynamask_roi_head.py:build_dynamask_roi_head``
(:422-464) that the DynaMask Mask R-CNN configs use).

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
from .layers import init_weights
from .rpn_head import RPNHead

# the registered modules must be imported for their registry entries
from . import detectors, fpn, resnet  # noqa: F401


def _cfg(d) -> dict:
    return dict(d) if d else {}


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


def build_roi_head(cfg: dict, train_cfg: dict, test_cfg: dict):
    cfg = _cfg(cfg)
    t = cfg.pop('type')
    if t != 'DynaMaskRoIHead':
        raise KeyError(f'unsupported roi head {t}: the port has the '
                       'DynaMask RoI head only')
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
    bbox_extractor = _cfg(cfg.get('bbox_roi_extractor'))
    mask_extractor = _cfg(cfg.get('mask_roi_extractor'))
    rcnn_test = _cfg(_cfg(test_cfg).get('rcnn'))
    nms_cfg = _cfg(rcnn_test.get('nms'))
    if nms_cfg.get('type', 'nms') != 'nms':
        raise NotImplementedError(f'test nms type {nms_cfg["type"]}')

    mhc = _cfg(cfg['mask_head'])
    if mhc.pop('type') != 'DynaMaskHead':
        raise KeyError('unsupported mask head: the port has DynaMaskHead only')
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
              or bbox_extractor.get('out_channels', 256))
    return DynaMaskRoIHead(
        bbox_head, mask_head,
        MaskPre(num_choices=len(stage_sup_size), in_channels=msm_in),
        dynamic_inference=cfg.get('dynamic_inference', False),
        dynamic_capacity=tuple(cfg.get('dynamic_capacity',
                                       (0.5, 0.25, 0.125))),
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
        max_per_img=rcnn_test.get('max_per_img', 100))


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
        rpn_nms_thr=rpn_proposal.get('nms_thr', 0.7)))
    det = det.to_empty(device=dev)
    init_weights(det, torch.Generator(device=dev).manual_seed(seed), init_std)
    if init_std is None:
        with torch.no_grad():
            det.roi_head.mask_head.loss_func.detail_target.fuse_kernel.copy_(
                torch.tensor([0.7, 0.3]).reshape(1, 2, 1, 1))
    return det.eval().to(memory_format=torch.channels_last)
