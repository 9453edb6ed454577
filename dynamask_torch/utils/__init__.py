from .config import Config, ConfigDict
from .registry import Registry, BACKBONES, NECKS, HEADS, DETECTORS
from .device import resolve_device

__all__ = ['Config', 'ConfigDict', 'Registry', 'BACKBONES', 'NECKS', 'HEADS',
           'DETECTORS', 'resolve_device']
