from .config import Config, ConfigDict
from .registry import (Registry, BACKBONES, NECKS, HEADS, DETECTORS,
                       DATASETS, PIPELINES)
from .device import resolve_device

__all__ = ['Config', 'ConfigDict', 'Registry', 'BACKBONES', 'NECKS', 'HEADS',
           'DETECTORS', 'DATASETS', 'PIPELINES', 'resolve_device']
