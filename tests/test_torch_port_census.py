"""The config census: which files of ``configs/`` the port builds.

Every file outside ``configs/_base_/`` goes through ``Config.fromfile`` and
the port's ``build_detector`` on the ``meta`` device (the structure, no
weights; the builder's every check runs, the init does not). ``BUILDS``
is the set that builds, one case per file; every other file must be
refused with ``NotImplementedError`` naming what is missing (a ROADMAP.md
item or the key), never another error. A handful of refusals are held to
their message. The count went from 27 (``ROADMAP.md`` §1, before the box-only
detectors and the ResNet variants) to 82, with Cascade R-CNN and HTC to
113, with the two-stage family's options (GN and GN+WS, CARAFE,
GRoIE, Double-Head, the IoU losses, OHEM and Soft-NMS) to 143, and with
the single-stage detectors (RetinaNet with GHM, FreeAnchor, the legacy v1
form and the SepBN head; ATSS; FCOS) to 180, with HRNet and HRFPN,
RegNet (all but the mdconv file), Res2Net and PAFPN to 227, and with the
backbones' deformable convs and block plugins (``configs/dcn/`` but its
two RoI-pool files, ``gcnet/``, ``empirical_attention/``, GRoIE's two
GCB files, HTC X101-64x4d's dconv file, FCOS's ``dcn_on_last_conv`` file
and RegNetX-3.2GF's mdconv file: 37) to 264, and with guided anchoring
(``configs/guided_anchoring/`` but its Fast R-CNN file, which built
before: 16) and DetectoRS (``configs/detectors/``: 6) to 286. The
``dconv`` files of GFL and RepPoints are still refused, for their
detectors (item 6).
"""

import glob
import os

import pytest

torch = pytest.importorskip('torch')

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDS = (
    'albu_example/mask_rcnn_r50_fpn_albu_1x_coco.py',
    'atss/atss_r50_fpn_1x_coco.py',
    'carafe/faster_rcnn_r50_fpn_carafe_1x_coco.py',
    'carafe/mask_rcnn_r50_fpn_carafe_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r101_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r50_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_r50_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_32x4d_fpn_20e_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_64x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_mask_rcnn_x101_64x4d_fpn_20e_coco.py',
    'cascade_rcnn/cascade_rcnn_r101_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_r101_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_r101_fpn_20e_coco.py',
    'cascade_rcnn/cascade_rcnn_r50_caffe_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_r50_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_r50_fpn_20e_coco.py',
    'cascade_rcnn/cascade_rcnn_x101_32x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_x101_32x4d_fpn_20e_coco.py',
    'cascade_rcnn/cascade_rcnn_x101_64x4d_fpn_1x_coco.py',
    'cascade_rcnn/cascade_rcnn_x101_64x4d_fpn_20e_coco.py',
    'cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py',
    'cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py',
    'dcn/cascade_mask_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/cascade_mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/cascade_mask_rcnn_x101_32x4d_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/cascade_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/cascade_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/faster_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/faster_rcnn_r50_fpn_mdconv_c3-c5_1x_coco.py',
    'dcn/faster_rcnn_r50_fpn_mdconv_c3-c5_group4_1x_coco.py',
    'dcn/faster_rcnn_x101_32x4d_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/mask_rcnn_r101_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/mask_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py',
    'dcn/mask_rcnn_r50_fpn_mdconv_c3-c5_1x_coco.py',
    'deepfashion/mask_rcnn_r50_fpn_15e_deepfashion.py',
    'detectors/cascade_rcnn_r50_rfp_1x_coco.py',
    'detectors/cascade_rcnn_r50_sac_1x_coco.py',
    'detectors/detectors_cascade_rcnn_r50_1x_coco.py',
    'detectors/detectors_htc_r50_1x_coco.py',
    'detectors/htc_r50_rfp_1x_coco.py',
    'detectors/htc_r50_sac_1x_coco.py',
    'double_heads/dh_faster_rcnn_r50_fpn_1x_coco.py',
    'dynamask/cityscapes/r50_dynamask_cityscapes_1x.py',
    'dynamask/coco/r101_dynamask_3x.py',
    'dynamask/coco/r50_dynamask_1x.py',
    'dynamask/lvis/r50_dynamask_lvis_1x.py',
    'empirical_attention/faster_rcnn_r50_fpn_attention_0010_1x_coco.py',
    'empirical_attention/faster_rcnn_r50_fpn_attention_0010_dcn_1x_coco.py',
    'empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py',
    'empirical_attention/faster_rcnn_r50_fpn_attention_1111_dcn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r101_caffe_fpn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r101_fpn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r101_fpn_2x_coco.py',
    'fast_rcnn/fast_rcnn_r50_caffe_fpn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r50_fpn_1x_coco.py',
    'fast_rcnn/fast_rcnn_r50_fpn_2x_coco.py',
    'faster_rcnn/faster_rcnn_r101_caffe_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_r101_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_r101_fpn_2x_coco.py',
    'faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_caffe_fpn_mstrain_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_caffe_fpn_mstrain_2x_coco.py',
    'faster_rcnn/faster_rcnn_r50_caffe_fpn_mstrain_3x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_1x_coco-person-bicycle-car.py',
    'faster_rcnn/faster_rcnn_r50_fpn_1x_coco-person.py',
    'faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_2x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_bounded_iou_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_giou_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_iou_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_ohem_1x_coco.py',
    'faster_rcnn/faster_rcnn_r50_fpn_soft_nms_1x_coco.py',
    'faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_x101_32x4d_fpn_2x_coco.py',
    'faster_rcnn/faster_rcnn_x101_64x4d_fpn_1x_coco.py',
    'faster_rcnn/faster_rcnn_x101_64x4d_fpn_2x_coco.py',
    'fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_fpn_gn-head_4x4_1x'
    '_coco.py',
    'fcos/fcos_center-normbbox-centeronreg-giou_r50_caffe_fpn_gn-head_dcn_4x'
    '4_1x_coco.py',
    'fcos/fcos_center_r50_caffe_fpn_gn-head_4x4_1x_coco.py',
    'fcos/fcos_r101_caffe_fpn_gn-head_4x4_1x_coco.py',
    'fcos/fcos_r101_caffe_fpn_gn-head_4x4_2x_coco.py',
    'fcos/fcos_r101_caffe_fpn_gn-head_mstrain_640-800_4x4_2x_coco.py',
    'fcos/fcos_r50_caffe_fpn_4x4_1x_coco.py',
    'fcos/fcos_r50_caffe_fpn_gn-head_4x4_1x_coco.py',
    'fcos/fcos_r50_caffe_fpn_gn-head_4x4_2x_coco.py',
    'fcos/fcos_r50_caffe_fpn_gn-head_mstrain_640-800_4x4_2x_coco.py',
    'fcos/fcos_r50_fpn_1x_coco.py',
    'fcos/fcos_x101_64x4d_fpn_gn-head_mstrain_640-800_4x2_2x_coco.py',
    'fp16/faster_rcnn_r50_fpn_fp16_1x_coco.py',
    'fp16/mask_rcnn_r50_fpn_fp16_1x_coco.py',
    'fp16/retinanet_r50_fpn_fp16_1x_coco.py',
    'free_anchor/retinanet_free_anchor_r101_fpn_1x_coco.py',
    'free_anchor/retinanet_free_anchor_r50_fpn_1x_coco.py',
    'free_anchor/retinanet_free_anchor_x101_32x4d_fpn_1x_coco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_1x_coco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_dconv_c3-c5_1x_c'
    'oco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_dconv_c3-c5_r16_'
    'gcb_c3-c5_1x_coco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_dconv_c3-c5_r4_g'
    'cb_c3-c5_1x_coco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_r16_gcb_c3-c5_1x'
    '_coco.py',
    'gcnet/cascade_mask_rcnn_x101_32x4d_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_'
    'coco.py',
    'gcnet/mask_rcnn_r101_fpn_r16_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r101_fpn_r4_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r101_fpn_syncbn-backbone_1x_coco.py',
    'gcnet/mask_rcnn_r101_fpn_syncbn-backbone_r16_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r101_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r50_fpn_r16_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r50_fpn_syncbn-backbone_1x_coco.py',
    'gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r16_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_x101_32x4d_fpn_syncbn-backbone_1x_coco.py',
    'gcnet/mask_rcnn_x101_32x4d_fpn_syncbn-backbone_r16_gcb_c3-c5_1x_coco.py',
    'gcnet/mask_rcnn_x101_32x4d_fpn_syncbn-backbone_r4_gcb_c3-c5_1x_coco.py',
    'ghm/retinanet_ghm_r101_fpn_1x_coco.py',
    'ghm/retinanet_ghm_r50_fpn_1x_coco.py',
    'ghm/retinanet_ghm_x101_32x4d_fpn_1x_coco.py',
    'ghm/retinanet_ghm_x101_64x4d_fpn_1x_coco.py',
    'gn+ws/faster_rcnn_r101_fpn_gn_ws-all_1x_coco.py',
    'gn+ws/faster_rcnn_r50_fpn_gn_ws-all_1x_coco.py',
    'gn+ws/faster_rcnn_x101_32x4d_fpn_gn_ws-all_1x_coco.py',
    'gn+ws/faster_rcnn_x50_32x4d_fpn_gn_ws-all_1x_coco.py',
    'gn+ws/mask_rcnn_r101_fpn_gn_ws-all_20_23_24e_coco.py',
    'gn+ws/mask_rcnn_r101_fpn_gn_ws-all_2x_coco.py',
    'gn+ws/mask_rcnn_r50_fpn_gn_ws-all_20_23_24e_coco.py',
    'gn+ws/mask_rcnn_r50_fpn_gn_ws-all_2x_coco.py',
    'gn+ws/mask_rcnn_x101_32x4d_fpn_gn_ws-all_20_23_24e_coco.py',
    'gn+ws/mask_rcnn_x101_32x4d_fpn_gn_ws-all_2x_coco.py',
    'gn+ws/mask_rcnn_x50_32x4d_fpn_gn_ws-all_20_23_24e_coco.py',
    'gn+ws/mask_rcnn_x50_32x4d_fpn_gn_ws-all_2x_coco.py',
    'gn/mask_rcnn_r101_fpn_gn-all_2x_coco.py',
    'gn/mask_rcnn_r101_fpn_gn-all_3x_coco.py',
    'gn/mask_rcnn_r50_fpn_gn-all_2x_coco.py',
    'gn/mask_rcnn_r50_fpn_gn-all_3x_coco.py',
    'gn/mask_rcnn_r50_fpn_gn-all_contrib_2x_coco.py',
    'gn/mask_rcnn_r50_fpn_gn-all_contrib_3x_coco.py',
    'groie/faster_rcnn_r50_fpn_groie_1x_coco.py',
    'groie/mask_rcnn_r101_fpn_syncbn-backbone_r4_gcb_c3-c5_groie_1x_coco.py',
    'groie/mask_rcnn_r50_fpn_groie_1x_coco.py',
    'groie/mask_rcnn_r50_fpn_syncbn-backbone_r4_gcb_c3-c5_groie_1x_coco.py',
    'guided_anchoring/ga_fast_r50_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_r101_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_r50_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_r50_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_x101_32x4d_fpn_1x_coco.py',
    'guided_anchoring/ga_faster_x101_64x4d_fpn_1x_coco.py',
    'guided_anchoring/ga_retinanet_r101_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_retinanet_r101_caffe_fpn_mstrain_2x.py',
    'guided_anchoring/ga_retinanet_r50_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_retinanet_r50_fpn_1x_coco.py',
    'guided_anchoring/ga_retinanet_x101_32x4d_fpn_1x_coco.py',
    'guided_anchoring/ga_retinanet_x101_64x4d_fpn_1x_coco.py',
    'guided_anchoring/ga_rpn_r101_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_rpn_r50_caffe_fpn_1x_coco.py',
    'guided_anchoring/ga_rpn_r50_fpn_1x_coco.py',
    'guided_anchoring/ga_rpn_x101_32x4d_fpn_1x_coco.py',
    'guided_anchoring/ga_rpn_x101_64x4d_fpn_1x_coco.py',
    'hrnet/cascade_mask_rcnn_hrnetv2p_w18_20e_coco.py',
    'hrnet/cascade_mask_rcnn_hrnetv2p_w32_20e_coco.py',
    'hrnet/cascade_mask_rcnn_hrnetv2p_w40_20e_coco.py',
    'hrnet/cascade_rcnn_hrnetv2p_w18_20e_coco.py',
    'hrnet/cascade_rcnn_hrnetv2p_w32_20e_coco.py',
    'hrnet/cascade_rcnn_hrnetv2p_w40_20e_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w18_1x_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w18_2x_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w32_1x_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w32_2x_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w40_1x_coco.py',
    'hrnet/faster_rcnn_hrnetv2p_w40_2x_coco.py',
    'hrnet/fcos_hrnetv2p_w18_gn-head_4x4_1x_coco.py',
    'hrnet/fcos_hrnetv2p_w18_gn-head_4x4_2x_coco.py',
    'hrnet/fcos_hrnetv2p_w18_gn-head_mstrain_640-800_4x4_2x_coco.py',
    'hrnet/fcos_hrnetv2p_w32_gn-head_4x4_1x_coco.py',
    'hrnet/fcos_hrnetv2p_w32_gn-head_4x4_2x_coco.py',
    'hrnet/fcos_hrnetv2p_w32_gn-head_mstrain_640-800_4x4_2x_coco.py',
    'hrnet/fcos_hrnetv2p_w40_gn-head_mstrain_640-800_4x4_2x_coco.py',
    'hrnet/htc_hrnetv2p_w18_20e_coco.py',
    'hrnet/htc_hrnetv2p_w32_20e_coco.py',
    'hrnet/htc_hrnetv2p_w40_20e_coco.py',
    'hrnet/htc_hrnetv2p_w40_28e_coco.py',
    'hrnet/htc_x101_64x4d_fpn_16x1_28e_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w18_1x_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w18_2x_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w32_2x_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w40_1x_coco.py',
    'hrnet/mask_rcnn_hrnetv2p_w40_2x_coco.py',
    'htc/htc_r101_fpn_20e_coco.py',
    'htc/htc_r50_fpn_1x_coco.py',
    'htc/htc_r50_fpn_20e_coco.py',
    'htc/htc_without_semantic_r50_fpn_1x_coco.py',
    'htc/htc_x101_32x4d_fpn_16x1_20e_coco.py',
    'htc/htc_x101_64x4d_fpn_16x1_20e_coco.py',
    'htc/htc_x101_64x4d_fpn_dconv_c3-c5_mstrain_400_1400_16x1_20e_coco.py',
    'instaboost/cascade_mask_rcnn_r101_fpn_instaboost_4x_coco.py',
    'instaboost/cascade_mask_rcnn_r50_fpn_instaboost_4x_coco.py',
    'instaboost/cascade_mask_rcnn_x101_64x4d_fpn_instaboost_4x_coco.py',
    'instaboost/mask_rcnn_r101_fpn_instaboost_4x_coco.py',
    'instaboost/mask_rcnn_r50_fpn_instaboost_4x_coco.py',
    'instaboost/mask_rcnn_x101_64x4d_fpn_instaboost_4x_coco.py',
    'legacy_1.x/retinanet_r50_caffe_fpn_1x_coco_v1.py',
    'legacy_1.x/retinanet_r50_fpn_1x_coco_v1.py',
    'lvis/mask_rcnn_r101_fpn_sample1e-3_mstrain_1x_lvis_v1.py',
    'lvis/mask_rcnn_r101_fpn_sample1e-3_mstrain_2x_lvis_v0.5.py',
    'lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_1x_lvis_v1.py',
    'lvis/mask_rcnn_r50_fpn_sample1e-3_mstrain_2x_lvis_v0.5.py',
    'lvis/mask_rcnn_x101_32x4d_fpn_sample1e-3_mstrain_1x_lvis_v1.py',
    'lvis/mask_rcnn_x101_32x4d_fpn_sample1e-3_mstrain_2x_lvis_v0.5.py',
    'lvis/mask_rcnn_x101_64x4d_fpn_sample1e-3_mstrain_1x_lvis_v1.py',
    'lvis/mask_rcnn_x101_64x4d_fpn_sample1e-3_mstrain_2x_lvis_v0.5.py',
    'mask_rcnn/mask_rcnn_r101_caffe_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_r101_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_r101_fpn_2x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_mstrain-poly_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_mstrain-poly_2x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_mstrain-poly_3x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_mstrain_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_caffe_fpn_poly_1x_coco_v1.py',
    'mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_r50_fpn_2x_coco.py',
    'mask_rcnn/mask_rcnn_r50_fpn_poly_1x_coco.py',
    'mask_rcnn/mask_rcnn_x101_32x4d_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_x101_32x4d_fpn_2x_coco.py',
    'mask_rcnn/mask_rcnn_x101_32x8d_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_x101_32x8d_fpn_mstrain-poly_1x_coco.py',
    'mask_rcnn/mask_rcnn_x101_32x8d_fpn_mstrain-poly_3x_coco.py',
    'mask_rcnn/mask_rcnn_x101_64x4d_fpn_1x_coco.py',
    'mask_rcnn/mask_rcnn_x101_64x4d_fpn_2x_coco.py',
    'nas_fpn/retinanet_r50_fpn_crop640_50e_coco.py',
    'pafpn/faster_rcnn_r50_pafpn_1x_coco.py',
    'pascal_voc/faster_rcnn_r50_fpn_1x_voc0712.py',
    'pascal_voc/retinanet_r50_fpn_1x_voc0712.py',
    'refinemask/cityscapes/r50_refinemask_1x.py',
    'refinemask/coco/r101_refinemask_1x.py',
    'refinemask/coco/r101_refinemask_2x.py',
    'refinemask/coco/r50_refinemask_1x.py',
    'refinemask/coco/r50_refinemask_2x.py',
    'refinemask/lvis/r50_refinemask_lvis_1x.py',
    'regnet/faster_rcnn_regnetx-3.2GF_fpn_1x_coco.py',
    'regnet/faster_rcnn_regnetx-3.2GF_fpn_2x_coco.py',
    'regnet/faster_rcnn_regnetx-3.2GF_fpn_mstrain_3x_coco.py',
    'regnet/mask_rcnn_regnetx-12GF_fpn_1x_coco.py',
    'regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py',
    'regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py',
    'regnet/mask_rcnn_regnetx-3.2GF_fpn_mstrain_3x_coco.py',
    'regnet/mask_rcnn_regnetx-4GF_fpn_1x_coco.py',
    'regnet/mask_rcnn_regnetx-6.4GF_fpn_1x_coco.py',
    'regnet/mask_rcnn_regnetx-8GF_fpn_1x_coco.py',
    'regnet/retinanet_regnetx-1.6GF_fpn_1x_coco.py',
    'regnet/retinanet_regnetx-3.2GF_fpn_1x_coco.py',
    'regnet/retinanet_regnetx-800MF_fpn_1x_coco.py',
    'res2net/cascade_mask_rcnn_r2_101_fpn_20e_coco.py',
    'res2net/cascade_rcnn_r2_101_fpn_20e_coco.py',
    'res2net/faster_rcnn_r2_101_fpn_2x_coco.py',
    'res2net/htc_r2_101_fpn_20e_coco.py',
    'res2net/mask_rcnn_r2_101_fpn_2x_coco.py',
    'retinanet/retinanet_r101_caffe_fpn_1x_coco.py',
    'retinanet/retinanet_r101_fpn_1x_coco.py',
    'retinanet/retinanet_r101_fpn_2x_coco.py',
    'retinanet/retinanet_r50_caffe_fpn_1x_coco.py',
    'retinanet/retinanet_r50_caffe_fpn_mstrain_1x_coco.py',
    'retinanet/retinanet_r50_caffe_fpn_mstrain_2x_coco.py',
    'retinanet/retinanet_r50_caffe_fpn_mstrain_3x_coco.py',
    'retinanet/retinanet_r50_fpn_1x_coco.py',
    'retinanet/retinanet_r50_fpn_2x_coco.py',
    'retinanet/retinanet_x101_32x4d_fpn_1x_coco.py',
    'retinanet/retinanet_x101_32x4d_fpn_2x_coco.py',
    'retinanet/retinanet_x101_64x4d_fpn_1x_coco.py',
    'retinanet/retinanet_x101_64x4d_fpn_2x_coco.py',
    'rpn/rpn_r101_caffe_fpn_1x_coco.py',
    'rpn/rpn_r101_fpn_1x_coco.py',
    'rpn/rpn_r101_fpn_2x_coco.py',
    'rpn/rpn_r50_caffe_fpn_1x_coco.py',
    'rpn/rpn_r50_fpn_1x_coco.py',
    'rpn/rpn_r50_fpn_2x_coco.py',
    'rpn/rpn_x101_32x4d_fpn_1x_coco.py',
    'rpn/rpn_x101_32x4d_fpn_2x_coco.py',
    'rpn/rpn_x101_64x4d_fpn_1x_coco.py',
    'rpn/rpn_x101_64x4d_fpn_2x_coco.py',
    'scratch/faster_rcnn_r50_fpn_gn-all_scratch_6x_coco.py',
    'scratch/mask_rcnn_r50_fpn_gn-all_scratch_6x_coco.py',
)
REFUSED = {
    'groie/grid_rcnn_r50_fpn_gn-head_groie_1x_coco.py': 'item 9',
    'legacy_1.x/faster_rcnn_r50_fpn_1x_coco_v1.py': '3c',
    'legacy_1.x/cascade_mask_rcnn_r50_fpn_1x_coco_v1.py': '3c',
    'gfl/gfl_r101_fpn_dconv_c3-c5_mstrain_2x_coco.py': 'item 6',
    'gfl/gfl_r50_fpn_1x_coco.py': 'item 6',
    'reppoints/reppoints_moment_r101_fpn_dconv_c3-c5_gn-neck+head_2x_coco.py':
        'item 6',
    'nas_fpn/retinanet_r50_nasfpn_crop640_50e_coco.py': 'item 8',
    'dcn/faster_rcnn_r50_fpn_dpool_1x_coco.py': 'item 9',
    'dcn/faster_rcnn_r50_fpn_mdpool_1x_coco.py': 'item 9',
    'rpn/rpn_r50_caffe_c4_1x_coco.py': 'item 9',
    'libra_rcnn/libra_faster_rcnn_r50_fpn_1x_coco.py': 'item 8',
}


def _build(rel):
    from dynamask_torch.models import build_detector
    from dynamask_torch.utils.config import Config
    cfg = Config.fromfile(os.path.join(ROOT, 'configs', rel))
    return build_detector(cfg.model, cfg.get('train_cfg'),
                          cfg.get('test_cfg'), device='meta')


@pytest.mark.parametrize('rel', BUILDS)
def test_config_builds(rel):
    model = _build(rel)
    assert sum(p.numel() for p in model.parameters()) > 1e6


@pytest.mark.parametrize('rel,what', sorted(REFUSED.items()))
def test_config_refused_naming_what_is_missing(rel, what):
    with pytest.raises(NotImplementedError, match=what):
        _build(rel)


def test_census_is_the_whole_set():
    """Every other config file is refused with ``NotImplementedError``;
    the building set is exactly ``BUILDS``."""
    files = sorted(os.path.relpath(f, os.path.join(ROOT, 'configs'))
                   for f in glob.glob(os.path.join(ROOT, 'configs', '**',
                                                   '*.py'), recursive=True)
                   if '_base_' not in f)
    built, wrong = [], {}
    for rel in files:
        try:
            _build(rel)
            built.append(rel)
        except NotImplementedError:
            pass
        except Exception as e:      # noqa: BLE001 - the census's point
            wrong[rel] = f'{type(e).__name__}: {e}'
    assert not wrong, wrong
    assert built == sorted(BUILDS)
    assert len(files) == 364
