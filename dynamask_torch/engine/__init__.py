from .checkpoint import load_checkpoint, load_params_only, save_checkpoint
from .convert import load_jax_variables, mmdet_key
from .fuse import conv_bn_pairs, fuse_conv_bn
from .optimizer import DetectorSGD, build_optimizer, step_lr_schedule
from .pretrained import (apply_pretrained, load_torch_state_dict,
                         resolve_pretrained_path)
from .train import make_train_step
from .train_state import (FusedAllReduce, active_group, destroy_group,
                          init_group, init_group_from_env)

__all__ = ['load_checkpoint', 'load_params_only', 'save_checkpoint',
           'load_jax_variables', 'mmdet_key', 'conv_bn_pairs',
           'fuse_conv_bn', 'DetectorSGD',
           'build_optimizer', 'step_lr_schedule', 'apply_pretrained',
           'load_torch_state_dict', 'resolve_pretrained_path',
           'make_train_step', 'FusedAllReduce', 'active_group',
           'destroy_group', 'init_group', 'init_group_from_env']
