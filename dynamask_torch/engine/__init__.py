from .convert import load_jax_variables, mmdet_key

__all__ = ['load_jax_variables', 'mmdet_key']
