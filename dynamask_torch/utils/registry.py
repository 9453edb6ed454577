"""String-keyed registries for config-driven module construction.

The port's own copy of ``dynamask_tpu/utils/registry.py``: the JAX registry
raises on a duplicate name, so the two packages cannot share registries.
``cfg = dict(type='FPN', ...)`` resolves by name exactly as there.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> class/function registry."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return dict(self._module_dict)

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return (f'{self.__class__.__name__}(name={self._name}, '
                f'items={sorted(self._module_dict)})')

    def get(self, key: str) -> Optional[Any]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None,
                        force: bool = False,
                        module: Optional[Any] = None) -> Callable:
        """Register a class or function, usable as decorator or direct call."""
        if module is not None:
            self._register(module, name=name, force=force)
            return module

        def _decorator(cls):
            self._register(cls, name=name, force=force)
            return cls

        return _decorator

    def _register(self, module: Any, name: Optional[str], force: bool) -> None:
        if not (inspect.isclass(module) or inspect.isfunction(module)):
            raise TypeError(f'module must be a class or function, got {type(module)}')
        key = name if name is not None else module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self._name}')
        self._module_dict[key] = module

    def build(self, cfg: dict, **default_kwargs) -> Any:
        """Instantiate ``cfg['type']`` with the remaining keys as kwargs
        (``default_kwargs`` fill in keys the cfg lacks)."""
        if not isinstance(cfg, dict) or 'type' not in cfg:
            raise TypeError(f'cfg must be a dict with a "type" key, got {cfg!r}')
        cfg = dict(cfg)
        obj_type = cfg.pop('type')
        obj_cls = self.get(obj_type) if isinstance(obj_type, str) else obj_type
        if obj_cls is None:
            raise KeyError(f'{obj_type} is not registered in the {self._name} '
                           f'registry. Available: {sorted(self._module_dict)}')
        for k, v in default_kwargs.items():
            cfg.setdefault(k, v)
        return obj_cls(**cfg)


BACKBONES = Registry('backbone')
NECKS = Registry('neck')
HEADS = Registry('head')
DETECTORS = Registry('detector')
