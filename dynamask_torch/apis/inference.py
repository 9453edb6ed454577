"""Inference entry points (port of ``init_detector`` /
``inference_detector`` of ``dynamask_tpu/apis/inference.py``), on a batch
that is already preprocessed: the image pipeline is not ported yet."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch.profiler import record_function

from ..models.builder import build_detector
from ..utils.config import Config
from .test import paste_epilogue


def init_detector(config: Union[str, Config], checkpoint: Optional[str] = None,
                  device=None, seed: int = 0,
                  init_std: Optional[float] = None) -> torch.nn.Module:
    """Build the config's detector on ``device`` (default ``cuda``, raising
    without a GPU unless ``device='cpu'``). ``checkpoint`` is a port
    ``state_dict`` file; without one the weights come from ``seed``."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_detector(config.model, config.get('train_cfg'),
                           config.get('test_cfg'), device=device, seed=seed,
                           init_std=init_std)
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location=model.device,
                           weights_only=True)
        model.load_state_dict(state.get('state_dict', state))
    model.cfg = config
    return model


def inference_detector(model: torch.nn.Module,
                       batch: Dict[str, torch.Tensor]) -> Dict:
    """``simple_test`` + device-side paste on a preprocessed batch
    (``image`` (B, H, W, 3) NHWC, ``img_shape`` (B, 2), ``scale_factor``
    (B, 4)). Masks land on the image extent and are thresholded at the
    config's ``mask_thr_binary`` (0.5 without a config)."""
    dev = model.device
    batch = {k: v.to(dev) for k, v in batch.items()}
    cfg = getattr(model, 'cfg', None)
    rcnn = ((cfg.get('test_cfg') or {}).get('rcnn') or {}) if cfg else {}
    mask_thr = rcnn.get('mask_thr_binary', 0.5)
    ch, cw = batch['image'].shape[1:3]
    with torch.no_grad():
        out = model.simple_test(batch)
        with record_function('paste'):
            result = paste_epilogue(out, ch, cw, mask_thr)
    if 'msm_routing' in out:
        result['msm_routing'] = out['msm_routing']
    return result
