"""Python-file config system with ``_base_`` inheritance (the port's own copy of
``dynamask_tpu/utils/config.py``, so ``dynamask_torch`` reads the same
``configs/`` files without importing the JAX package).

Mirrors the public behaviour of ``mmcv.Config.fromfile`` as the reference uses it
(reference: root train.py / test.py load python-dict configs; stock configs inherit
via ``_base_`` lists while DynaMask's own configs are flat — SURVEY.md §5 "Config /
flag system"). A config file is an ordinary python module whose module-level
variables become the config dict; ``_base_ = ['../x.py', ...]`` deep-merges parents
first (later entries and the child win); ``_delete_=True`` inside a dict replaces
instead of merging. CLI ``--options a.b.c=v`` overrides merge via
:meth:`Config.merge_from_options`.
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, Optional


class ConfigDict(dict):
    """A dict with attribute access (missing attributes raise AttributeError)."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError:
            raise AttributeError(name) from None
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def copy(self) -> 'ConfigDict':
        return ConfigDict(self)

    def get(self, key, default=None):
        return super().get(key, default)

    def pop(self, key, *args):
        return super().pop(key, *args)

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def _to_configdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


DELETE_KEY = '_delete_'
BASE_KEY = '_base_'


def _merge_dict(base: dict, override: dict) -> dict:
    """Deep-merge ``override`` into ``base`` (override wins); honours ``_delete_``."""
    merged = dict(base)
    for key, value in override.items():
        if (isinstance(value, dict) and key in merged
                and isinstance(merged[key], dict)
                and not value.get(DELETE_KEY, False)):
            merged[key] = _merge_dict(merged[key], value)
        else:
            if isinstance(value, dict):
                value = {k: v for k, v in value.items() if k != DELETE_KEY}
            merged[key] = value
    return merged


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = os.path.abspath(os.path.expanduser(filename))
    if not os.path.isfile(filename):
        raise FileNotFoundError(f'config file not found: {filename}')
    with open(filename, encoding='utf-8') as f:
        source = f.read()
    # validate syntax early for a readable error
    ast.parse(source, filename=filename)
    module = types.ModuleType('_cfg_')
    module.__file__ = filename
    exec(compile(source, filename, 'exec'), module.__dict__)
    cfg = {k: v for k, v in module.__dict__.items()
           if not k.startswith('__') and not isinstance(v, types.ModuleType)
           and not callable(v)}
    return cfg


def _load_with_bases(filename: str) -> Dict[str, Any]:
    cfg = _exec_pyfile(filename)
    bases = cfg.pop(BASE_KEY, None)
    if bases is None:
        return cfg
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
    for base in bases:
        base_cfg = _load_with_bases(os.path.join(cfg_dir, base))
        merged = _merge_dict(merged, base_cfg)
    return _merge_dict(merged, cfg)


def _parse_scalar(value: str) -> Any:
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ('true', 'false'):
            return lowered == 'true'
        if lowered in ('none', 'null'):
            return None
        return value


class Config:
    """The resolved configuration object.

    Attribute and item access both work; ``cfg.model.backbone.depth`` etc.
    """

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None):
        cfg_dict = cfg_dict or {}
        object.__setattr__(self, '_cfg_dict', _to_configdict(cfg_dict))
        object.__setattr__(self, '_filename', filename)

    @staticmethod
    def fromfile(filename: str) -> 'Config':
        return Config(_load_with_bases(filename), filename=filename)

    @property
    def filename(self) -> Optional[str]:
        return self._filename

    def __getattr__(self, name: str) -> Any:
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name: str, value: Any) -> None:
        self._cfg_dict[name] = _to_configdict(value)

    def __getitem__(self, key: str) -> Any:
        return self._cfg_dict[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._cfg_dict[key] = _to_configdict(value)

    def __contains__(self, key: str) -> bool:
        return key in self._cfg_dict

    def get(self, key: str, default: Any = None) -> Any:
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg_dict))

    def merge_from_options(self, options: Dict[str, Any]) -> None:
        """Merge dotted-key overrides, e.g. ``{'model.backbone.depth': 101}``.

        String values are literal-eval'ed when possible (mirrors mmcv DictAction).
        """
        for full_key, value in options.items():
            if isinstance(value, str):
                value = _parse_scalar(value)
            node = self._cfg_dict
            keys = full_key.split('.')
            for key in keys[:-1]:
                if key not in node or not isinstance(node[key], dict):
                    node[key] = ConfigDict()
                node = node[key]
            node[keys[-1]] = _to_configdict(value)

    def dump(self) -> str:
        """Pretty-print the resolved config (tools/print_config.py equivalent)."""
        import pprint
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)

    def __repr__(self) -> str:
        return f'Config(file={self._filename})\n{self.dump()}'
