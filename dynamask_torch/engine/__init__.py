from .checkpoint import load_checkpoint, load_params_only, save_checkpoint
from .convert import load_jax_variables, mmdet_key
from .optimizer import DetectorSGD, build_optimizer, step_lr_schedule
from .pretrained import (apply_pretrained, load_torch_state_dict,
                         resolve_pretrained_path)
from .train import make_train_step

__all__ = ['load_checkpoint', 'load_params_only', 'save_checkpoint',
           'load_jax_variables', 'mmdet_key', 'DetectorSGD',
           'build_optimizer', 'step_lr_schedule', 'apply_pretrained',
           'load_torch_state_dict', 'resolve_pretrained_path',
           'make_train_step']
