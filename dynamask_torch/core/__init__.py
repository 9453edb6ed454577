from .anchors import AnchorGenerator
from .bbox_transforms import (bbox2delta, bbox2result, bbox_overlaps,
                              clip_boxes, delta2bbox)
from .boundary import generate_block_target, interpolate_bilinear
from .class_names import get_classes
from .coders import DeltaXYWHBBoxCoder
from .fp16 import cast_floating, to_bf16, to_f32

__all__ = ['AnchorGenerator', 'bbox2delta', 'bbox2result', 'bbox_overlaps',
           'clip_boxes', 'delta2bbox', 'generate_block_target', 'interpolate_bilinear',
           'DeltaXYWHBBoxCoder', 'get_classes', 'cast_floating', 'to_bf16',
           'to_f32']
