"""Device selection for the port's entry points.

The port runs on the GPU. An entry point given no device takes ``cuda`` and
raises when no GPU is present; the CPU is used only when the caller names it
(the CPU tests do, to run the plain PyTorch forms of the kernels).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raising without a GPU); otherwise the named
    device, which must exist."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'dynamask_torch runs on a CUDA device and none is available; '
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
