from .builder import build_detector
from .detectors import MaskRCNN
from .dynamask_head import (ClassSelectConv1x1, DCNPack, DynaMaskHead,
                            MaskPre, SFMStage)
from .dynamask_roi_head import DynaMaskRoIHead, routing_clip_stats
from .fpn import FPN
from .resnet import ResNet
from .rpn_head import RPNHead, rpn_get_proposals

__all__ = ['build_detector', 'MaskRCNN', 'ClassSelectConv1x1', 'DCNPack',
           'DynaMaskHead', 'MaskPre', 'SFMStage', 'DynaMaskRoIHead',
           'routing_clip_stats', 'FPN', 'ResNet', 'RPNHead',
           'rpn_get_proposals']
