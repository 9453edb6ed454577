from .convert import load_jax_variables, mmdet_key
from .optimizer import DetectorSGD, build_optimizer, step_lr_schedule
from .train import make_train_step

__all__ = ['load_jax_variables', 'mmdet_key', 'DetectorSGD',
           'build_optimizer', 'step_lr_schedule', 'make_train_step']
