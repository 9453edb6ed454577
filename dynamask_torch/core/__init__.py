from .anchors import AnchorGenerator
from .bbox_transforms import (bbox2delta, bbox_overlaps, clip_boxes,
                              delta2bbox)
from .boundary import generate_block_target, interpolate_bilinear
from .coders import DeltaXYWHBBoxCoder

__all__ = ['AnchorGenerator', 'bbox2delta', 'bbox_overlaps', 'clip_boxes',
           'delta2bbox', 'generate_block_target', 'interpolate_bilinear',
           'DeltaXYWHBBoxCoder']
