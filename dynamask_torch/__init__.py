"""dynamask_torch — the PyTorch/CUDA port of ``dynamask_tpu`` for NVIDIA
Hopper GPUs.

It mirrors the JAX package's layout (``utils``, ``core``, ``ops``,
``models``, ``engine``, ``apis``, ``data``, ``native``, ``tools``) and
imports neither JAX nor the JAX package. The windowed-DCN sampling (K1) and RoIAlign (K2) run as
hand-written CUDA kernels built at first use from ``ops/csrc``; entry points
run on the GPU unless the caller passes ``device='cpu'``.
"""

__version__ = '0.1.0'
