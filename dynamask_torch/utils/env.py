"""Environment report (port of ``collect_env``,
``dynamask_tpu/utils/env.py:21``): the versions a training log needs to be
read later, with the JAX backend rows replaced by the CUDA ones and the
card's name and power limit as ``nvidia-smi`` reports them."""

from __future__ import annotations

import platform
import shutil
import subprocess
import sys
from typing import Dict, List


def _output(cmd) -> List[str]:
    """A command's output lines; none when it cannot run or fails."""
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                              check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return []


def collect_env() -> Dict[str, str]:
    """Python, platform, PyTorch, CUDA (PyTorch's build and ``nvcc``'s),
    the GPUs and the first card's ``name, power.limit``, cv2, NumPy and the
    port's version."""
    import numpy
    import torch
    import dynamask_torch
    from ..ops._build import nvcc_path
    env: Dict[str, str] = {
        'sys.platform': sys.platform,
        'Python': sys.version.replace('\n', ''),
        'Platform': platform.platform(),
        'PyTorch': torch.__version__,
        'PyTorch CUDA': str(torch.version.cuda),
        'CUDA available': str(torch.cuda.is_available()),
    }
    try:
        nvcc = nvcc_path()
    except RuntimeError:
        env['NVCC'] = 'not found'
    else:
        release = [ln for ln in _output([nvcc, '--version'])
                   if 'release' in ln]
        env['NVCC'] = f'{nvcc}: {release[0] if release else "unknown"}'
    if torch.cuda.is_available():
        env['GPU count'] = str(torch.cuda.device_count())
        env['GPU 0'] = torch.cuda.get_device_name(0)
    if shutil.which('nvidia-smi'):
        card = _output(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'])
        env['nvidia-smi name, power.limit'] = card[0] if card else 'failed'
    try:
        import cv2
        env['OpenCV'] = cv2.__version__
    except ImportError:
        env['OpenCV'] = 'not installed'
    env['NumPy'] = numpy.__version__
    env['dynamask_torch'] = dynamask_torch.__version__
    return env

