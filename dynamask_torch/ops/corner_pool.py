"""Corner pooling (port of ``dynamask_tpu/ops/corner_pool.py:21``): a
running maximum along one axis, ``lax.cummax`` in JAX, ``torch.cummax``
here (flipped for the reverse directions). Plain PyTorch: XLA in JAX.

``top`` pools from the bottom up (out[y] = max over y' >= y), ``bottom``
from the top down, ``left`` from the right leftward, ``right`` from the
left rightward.
"""

from __future__ import annotations

import torch

# direction -> (NCHW axis, whether the scan runs from the far edge)
DIRECTIONS = {'top': (2, True), 'bottom': (2, False), 'left': (3, True),
              'right': (3, False)}


def corner_pool(x: torch.Tensor, direction: str) -> torch.Tensor:
    """(N, C, H, W) directional running maximum."""
    if direction not in DIRECTIONS:
        raise ValueError(f'unknown corner pool direction: {direction}')
    axis, reverse = DIRECTIONS[direction]
    if reverse:
        return torch.cummax(x.flip(axis), axis).values.flip(axis)
    return torch.cummax(x, axis).values
