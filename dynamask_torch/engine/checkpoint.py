"""Checkpoint save and load (port of ``dynamask_tpu/engine/checkpoint.py``).

The reference's contract (mmcv ``CheckpointHook``): ``epoch_{N}`` each
checkpoint epoch and a ``latest`` pointer; ``resume_from`` restores the
model, the optimizer and the progress, ``load_from`` the weights only. A
checkpoint is one ``torch.save`` file, ``epoch_{N}.pth``, in mmcv's layout
``{'meta': {epoch, step, CLASSES, config}, 'state_dict': ...,
'optimizer': ...}`` with every tensor on the CPU, so it loads on either
device. The ``state_dict`` has the mmdet names, so ``init_detector``, the
eval CLI and the JAX package's ``load_torch_state_dict`` read it as it is.
``latest`` is a text file holding the name of the newest checkpoint.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

from .optimizer import DetectorSGD


def _to_cpu(obj):
    """``obj`` with every tensor in it copied to the CPU."""
    if torch.is_tensor(obj):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(work_dir: str, model: torch.nn.Module,
                    optimizer: DetectorSGD, epoch: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``work_dir/epoch_{epoch}.pth`` (``meta`` plus ``epoch`` and the
    optimizer's ``step``), then point ``latest`` at it. Returns the path."""
    name = f'epoch_{epoch}.pth'
    path = osp.abspath(osp.join(work_dir, name))
    meta = dict(meta or {}, epoch=epoch, step=optimizer.steps)
    ckpt = {'meta': meta, 'state_dict': _to_cpu(model.state_dict()),
            'optimizer': _to_cpu(optimizer.state_dict())}
    tmp = f'{path}.tmp'
    torch.save(ckpt, tmp)
    os.replace(tmp, path)     # a cut save never leaves a partial epoch file
    latest = osp.join(work_dir, 'latest')
    with open(f'{latest}.tmp', 'w') as f:
        f.write(name)
    os.replace(f'{latest}.tmp', latest)
    return path


def _resolve_ckpt_path(path: str) -> str:
    """Accept a work_dir (-> its ``latest``), the ``latest`` pointer file
    itself, or a checkpoint file."""
    if osp.isfile(osp.join(path, 'latest')):
        path = osp.join(path, 'latest')
    if osp.basename(path) == 'latest' and osp.isfile(path):
        with open(path) as f:
            return osp.join(osp.dirname(path), f.read().strip())
    return path


def _read(path: str) -> Dict[str, Any]:
    return torch.load(_resolve_ckpt_path(path), map_location='cpu',
                      weights_only=True)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[DetectorSGD] = None
                    ) -> Dict[str, Any]:
    """Restore the model (and the optimizer, given one) from a checkpoint
    written by :func:`save_checkpoint`; returns its meta. ``path`` as
    :func:`_resolve_ckpt_path` takes it."""
    ckpt = _read(path)
    model.load_state_dict(ckpt['state_dict'])
    if optimizer is not None:
        optimizer.load_state_dict(ckpt['optimizer'])
    return ckpt.get('meta', {})


def load_params_only(path: str, model: torch.nn.Module) -> Dict[str, Any]:
    """``load_from`` semantics: the weights and BatchNorm statistics only;
    the optimizer and the progress start afresh. Returns the meta."""
    ckpt = _read(path)
    model.load_state_dict(ckpt.get('state_dict', ckpt))
    return ckpt.get('meta', {})
