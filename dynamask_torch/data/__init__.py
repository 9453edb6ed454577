from .mask_codec import (encode_mask, decode_rle, encode_mask_plain,
                         decode_rle_plain, polygons_to_mask, ann_to_mask,
                         rle_area, rle_iou, segm_iou, mask_to_rle_counts,
                         rle_counts_to_mask, rle_counts_to_string,
                         rle_string_to_counts)
from .cocoeval import CocoEvaluator, bbox_iou_xywh
from .transforms import (LoadImageFromFile, LoadAnnotations, Resize,
                         RandomFlip, Normalize, Pad, Compose)
from .formatting import format_sample, collate, canvas_for
from .coco import CocoDataset, CocoIndex, build_dataset, COCO_CLASSES
from .dataset_wrappers import (ConcatDataset, RepeatDataset,
                               ClassBalancedDataset, wrap_dataset)
from .loader import GroupedBatchSampler, build_dataloader

__all__ = [
    'encode_mask', 'decode_rle', 'encode_mask_plain', 'decode_rle_plain',
    'polygons_to_mask', 'ann_to_mask', 'rle_area', 'rle_iou', 'segm_iou',
    'mask_to_rle_counts', 'rle_counts_to_mask', 'rle_counts_to_string',
    'rle_string_to_counts',
    'CocoEvaluator', 'bbox_iou_xywh',
    'LoadImageFromFile', 'LoadAnnotations', 'Resize', 'RandomFlip',
    'Normalize', 'Pad', 'Compose', 'format_sample', 'collate', 'canvas_for',
    'CocoDataset', 'CocoIndex', 'build_dataset', 'COCO_CLASSES',
    'ConcatDataset', 'RepeatDataset', 'ClassBalancedDataset', 'wrap_dataset',
    'GroupedBatchSampler', 'build_dataloader',
]
