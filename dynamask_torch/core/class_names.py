"""Dataset class-name catalog and the ``get_classes`` alias dispatcher
(port of ``dynamask_tpu/core/class_names.py:60-120``, itself the
reference's ``mmdet/core/evaluation/class_names.py:4-116``).

The COCO and Cityscapes tuples are the ones the port's datasets define
(``dynamask_torch.data``), read lazily to keep ``core`` free of a ``data``
import; VOC's and DeepFashion's, whose datasets the port has not got, are
copied here. ImageNet DET/VID are the standard ILSVRC label lists.
"""

from __future__ import annotations

from typing import List

IMAGENET_VID_CLASSES = (
    'airplane', 'antelope', 'bear', 'bicycle', 'bird', 'bus', 'car',
    'cattle', 'dog', 'domestic_cat', 'elephant', 'fox', 'giant_panda',
    'hamster', 'horse', 'lion', 'lizard', 'monkey', 'motorcycle', 'rabbit',
    'red_panda', 'sheep', 'snake', 'squirrel', 'tiger', 'train', 'turtle',
    'watercraft', 'whale', 'zebra')

IMAGENET_DET_CLASSES = (
    'accordion', 'airplane', 'ant', 'antelope', 'apple', 'armadillo',
    'artichoke', 'axe', 'baby_bed', 'backpack', 'bagel', 'balance_beam',
    'banana', 'band_aid', 'banjo', 'baseball', 'basketball', 'bathing_cap',
    'beaker', 'bear', 'bee', 'bell_pepper', 'bench', 'bicycle', 'binder',
    'bird', 'bookshelf', 'bow_tie', 'bow', 'bowl', 'brassiere', 'burrito',
    'bus', 'butterfly', 'camel', 'can_opener', 'car', 'cart', 'cattle',
    'cello', 'centipede', 'chain_saw', 'chair', 'chime', 'cocktail_shaker',
    'coffee_maker', 'computer_keyboard', 'computer_mouse', 'corkscrew',
    'cream', 'croquet_ball', 'crutch', 'cucumber', 'cup_or_mug', 'diaper',
    'digital_clock', 'dishwasher', 'dog', 'domestic_cat', 'dragonfly',
    'drum', 'dumbbell', 'electric_fan', 'elephant', 'face_powder', 'fig',
    'filing_cabinet', 'flower_pot', 'flute', 'fox', 'french_horn', 'frog',
    'frying_pan', 'giant_panda', 'goldfish', 'golf_ball', 'golfcart',
    'guacamole', 'guitar', 'hair_dryer', 'hair_spray', 'hamburger',
    'hammer', 'hamster', 'harmonica', 'harp', 'hat_with_a_wide_brim',
    'head_cabbage', 'helmet', 'hippopotamus', 'horizontal_bar', 'horse',
    'hotdog', 'iPod', 'isopod', 'jellyfish', 'koala_bear', 'ladle',
    'ladybug', 'lamp', 'laptop', 'lemon', 'lion', 'lipstick', 'lizard',
    'lobster', 'maillot', 'maraca', 'microphone', 'microwave', 'milk_can',
    'miniskirt', 'monkey', 'motorcycle', 'mushroom', 'nail', 'neck_brace',
    'oboe', 'orange', 'otter', 'pencil_box', 'pencil_sharpener', 'perfume',
    'person', 'piano', 'pineapple', 'ping-pong_ball', 'pitcher', 'pizza',
    'plastic_bag', 'plate_rack', 'pomegranate', 'popsicle', 'porcupine',
    'power_drill', 'pretzel', 'printer', 'puck', 'punching_bag', 'purse',
    'rabbit', 'racket', 'ray', 'red_panda', 'refrigerator',
    'remote_control', 'rubber_eraser', 'rugby_ball', 'ruler',
    'salt_or_pepper_shaker', 'saxophone', 'scorpion', 'screwdriver',
    'seal', 'sheep', 'ski', 'skunk', 'snail', 'snake', 'snowmobile',
    'snowplow', 'soap_dispenser', 'soccer_ball', 'sofa', 'spatula',
    'squirrel', 'starfish', 'stethoscope', 'stove', 'strainer',
    'strawberry', 'stretcher', 'sunglasses', 'swimming_trunks', 'swine',
    'syringe', 'table', 'tape_player', 'tennis_ball', 'tick', 'tie',
    'tiger', 'toaster', 'traffic_light', 'train', 'trombone', 'trumpet',
    'turtle', 'tv_or_monitor', 'unicycle', 'vacuum', 'violin',
    'volleyball', 'waffle_iron', 'washer', 'water_bottle', 'watercraft',
    'whale', 'wine_bottle', 'zebra')


VOC_CLASSES = ('aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor')

DEEPFASHION_CLASSES = ('top', 'skirt', 'leggings', 'dress', 'outer', 'pants',
                       'bag', 'neckwear', 'headwear', 'eyeglass', 'belt',
                       'footwear', 'hair', 'skin', 'face')


def coco_classes() -> List[str]:
    from ..data.coco import COCO_CLASSES
    return list(COCO_CLASSES)


def voc_classes() -> List[str]:
    return list(VOC_CLASSES)


def cityscapes_classes() -> List[str]:
    from ..data.cityscapes import CITYSCAPES_CLASSES
    return list(CITYSCAPES_CLASSES)


def wider_face_classes() -> List[str]:
    return ['face']


def imagenet_det_classes() -> List[str]:
    return list(IMAGENET_DET_CLASSES)


def imagenet_vid_classes() -> List[str]:
    return list(IMAGENET_VID_CLASSES)


def deepfashion_classes() -> List[str]:
    return list(DEEPFASHION_CLASSES)


dataset_aliases = {
    'voc': ['voc', 'pascal_voc', 'voc07', 'voc12'],
    'imagenet_det': ['det', 'imagenet_det', 'ilsvrc_det'],
    'imagenet_vid': ['vid', 'imagenet_vid', 'ilsvrc_vid'],
    'coco': ['coco', 'mscoco', 'ms_coco'],
    'wider_face': ['WIDERFaceDataset', 'wider_face', 'WDIERFace'],
    'cityscapes': ['cityscapes'],
    'deepfashion': ['deepfashion', 'DeepFashion'],
}

_FUNCS = {
    'voc': voc_classes,
    'imagenet_det': imagenet_det_classes,
    'imagenet_vid': imagenet_vid_classes,
    'coco': coco_classes,
    'wider_face': wider_face_classes,
    'cityscapes': cityscapes_classes,
    'deepfashion': deepfashion_classes,
}


def get_classes(dataset: str) -> List[str]:
    """Class names for a dataset alias (reference class_names.py:102-116)."""
    if not isinstance(dataset, str):
        raise TypeError(f'dataset must be a str, but got {type(dataset)}')
    for name, aliases in dataset_aliases.items():
        if dataset in aliases:
            return _FUNCS[name]()
    raise ValueError(f'Unrecognized dataset: {dataset}')
