"""``pretrained=`` weights for training (port of
``dynamask_tpu/engine/pretrained.py``: ``resolve_pretrained_path`` :43-66,
``load_torch_state_dict`` :69-80 and ``apply_pretrained`` :366-387).

The port's modules carry the mmdet ``state_dict`` names, so no layout
conversion is needed: a torchvision ResNet's names (``conv1.weight``,
``layer1.0.bn1.running_mean``, ...) take the ``backbone.`` prefix, and a
detector's mmdet names (``backbone.``, ``neck.``, ``rpn_head.``,
``roi_head.``, a single-stage detector's ``bbox_head.``) map one to one,
item 9's heads' among them (``mask_iou_head``, PointRend's coarse head in
mmdet's row order and its ``point_head``'s 1x1 ``Conv1d`` kernels,
``grid_head``'s grouped deconvs in mmdet's layout); Dynamic R-CNN's
state buffers, which an mmdet checkpoint lacks, stay at their start.
Nothing is downloaded: a spec that names no local file leaves the model as
initialised. A tensor whose shape differs from the model's is reported and
left as initialised, unless a module refuses it (its ``weight_fault``:
an mmdet RegNet's ``conv2.weight``, grouped otherwise than JAX's,
ROADMAP.md queue 3, 3ag; a ResNeXt's grouped ``conv2.weight`` for a
deformable 3x3, 3ao; an mmdet FCOS head's DCNv2 offsets), which raises. A
tensor the model lacks is reported as skipped, unless a module that sets
``refuses_missing_keys`` refuses it (an mmdet DetectoRS checkpoint's
``weight_gamma`` / ``weight_beta`` of ``ConvAWS``, 3at).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

__all__ = ['resolve_pretrained_path', 'load_torch_state_dict',
           'apply_pretrained']

MMDET_PREFIXES = ('backbone.', 'neck.', 'rpn_head.', 'roi_head.',
                  'bbox_head.')


def resolve_pretrained_path(spec: Optional[str]) -> Optional[str]:
    """A ``pretrained`` spec -> a local file, or None.

    ``torchvision://resnet50`` is looked for as ``resnet50-*`` (the model
    zoo's file names) or ``resnet50.pth`` in ``$TORCH_HOME/hub/checkpoints``
    (``~/.cache/torch`` without ``TORCH_HOME``), ``./pretrained`` and
    ``~/pretrained``; an ``open-mmlab://`` spec by its last part in the
    same places (``open-mmlab://msra/hrnetv2_w32`` as ``hrnetv2_w32-*``
    or ``hrnetv2_w32.pth``; ``regnetx_3.2gf``, ``res2net101_v1d_26w_4s``
    also as mmcv's ``<name>_mmdetv2-*``); an ``http(s)://`` spec resolves
    to None; a plain path is returned if it exists."""
    if not spec:
        return None
    for scheme in ('torchvision://', 'open-mmlab://'):
        if spec.startswith(scheme):
            name = spec[len(scheme):].rsplit('/', 1)[-1]
            stems = (name + '-', name + '_mmdetv2-')
            hub = os.path.join(os.environ.get(
                'TORCH_HOME', os.path.expanduser('~/.cache/torch')), 'hub',
                'checkpoints')
            for d in (hub, './pretrained',
                      os.path.expanduser('~/pretrained')):
                if os.path.isdir(d):
                    for f in sorted(os.listdir(d)):
                        if f.startswith(stems) or f == name + '.pth':
                            return os.path.join(d, f)
            return None
    if spec.startswith(('http://', 'https://')):
        return None
    return spec if os.path.exists(spec) else None


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file (its ``state_dict`` when it has
    one), on the CPU."""
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    sd = ckpt.get('state_dict', ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v for k, v in sd.items() if torch.is_tensor(v)}


def apply_pretrained(model: torch.nn.Module, spec: Optional[str],
                     logger=None) -> Dict[str, List[str]]:
    """Load ``pretrained=`` weights into ``model`` in place. Returns the
    report: the keys ``loaded``, ``skipped`` (no such tensor in the model)
    and ``mismatched`` (shapes differ; left as initialised). A spec that
    resolves to no file is logged and leaves the model as it is."""
    log = logger.info if logger else print
    report = {'loaded': [], 'skipped': [], 'mismatched': []}
    path = resolve_pretrained_path(spec)
    if path is None:
        log(f'pretrained "{spec}" not found locally - training from scratch')
        return report
    sd = load_torch_state_dict(path)
    mmdet = any(k.startswith(MMDET_PREFIXES) for k in sd)
    own = model.state_dict()
    faults = [(name + '.', m) for name, m in model.named_modules()
              if name and hasattr(m, 'weight_fault')]
    with torch.no_grad():
        for key, value in sd.items():
            name = key if mmdet else f'backbone.{key}'
            target = own.get(name)
            if target is None or target.shape != value.shape:
                why = next((m.weight_fault(name[len(p):], value.shape)
                            for p, m in faults if name.startswith(p) and (
                                target is not None or getattr(
                                    m, 'refuses_missing_keys', False))),
                           None)
                if why:
                    raise ValueError(f'pretrained {path}: {why}')
            if target is None:
                report['skipped'].append(key)
            elif target.shape != value.shape:
                report['mismatched'].append(
                    f'{key}: file {tuple(value.shape)} vs model '
                    f'{tuple(target.shape)}')
            else:
                target.copy_(value)
                report['loaded'].append(key)
    log(f'pretrained {path}: loaded {len(report["loaded"])} tensors, '
        f'skipped {len(report["skipped"])}, '
        f'mismatched {len(report["mismatched"])}')
    if logger:
        for m in report['mismatched'][:10]:
            logger.warning(f'  shape mismatch: {m}')
    return report
