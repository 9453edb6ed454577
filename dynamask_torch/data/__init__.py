from .mask_codec import (encode_mask, decode_rle, encode_mask_plain,
                         decode_rle_plain, polygons_to_mask, ann_to_mask,
                         rle_area, rle_iou, segm_iou, mask_to_rle_counts,
                         rle_counts_to_mask, rle_counts_to_string,
                         rle_string_to_counts)
from .cocoeval import CocoEvaluator, bbox_iou_xywh
from .transforms import (LoadImageFromFile, LoadAnnotations, LoadProposals,
                         Resize, RandomFlip, Normalize, Pad, Compose)
from .formatting import (format_sample, collate, canvas_for,
                         rasterize_semantic)
from .coco import (CocoDataset, CocoIndex, DeepFashionDataset, build_dataset,
                   dataset_spec, COCO_CLASSES)
from .lvis import (LVISV1Dataset, LVISV05Dataset, LvisEvaluator)
from .cityscapes import (CityscapesDataset, CITYSCAPES_CLASSES,
                         CITYSCAPES_LABEL_IDS)
from .custom import CustomDataset
from .voc import VOC_CLASSES, VOCDataset, WIDERFaceDataset, XMLDataset
from .dataset_wrappers import (ConcatDataset, RepeatDataset,
                               ClassBalancedDataset, wrap_dataset)
from .loader import GroupedBatchSampler, build_dataloader

__all__ = [
    'encode_mask', 'decode_rle', 'encode_mask_plain', 'decode_rle_plain',
    'polygons_to_mask', 'ann_to_mask', 'rle_area', 'rle_iou', 'segm_iou',
    'mask_to_rle_counts', 'rle_counts_to_mask', 'rle_counts_to_string',
    'rle_string_to_counts',
    'CocoEvaluator', 'bbox_iou_xywh',
    'LoadImageFromFile', 'LoadAnnotations', 'LoadProposals', 'Resize',
    'RandomFlip',
    'Normalize', 'Pad', 'Compose', 'format_sample', 'collate', 'canvas_for',
    'rasterize_semantic',
    'CocoDataset', 'CocoIndex', 'DeepFashionDataset', 'build_dataset',
    'dataset_spec',
    'COCO_CLASSES',
    'LVISV1Dataset', 'LVISV05Dataset', 'LvisEvaluator',
    'CityscapesDataset', 'CITYSCAPES_CLASSES', 'CITYSCAPES_LABEL_IDS',
    'CustomDataset', 'VOC_CLASSES', 'VOCDataset', 'WIDERFaceDataset',
    'XMLDataset',
    'ConcatDataset', 'RepeatDataset', 'ClassBalancedDataset', 'wrap_dataset',
    'GroupedBatchSampler', 'build_dataloader',
]
