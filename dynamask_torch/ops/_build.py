"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under the
checkout's ``build/`` directory and loaded with ``ctypes``. Libraries are
named by a hash of their source and flags, so an edited source is rebuilt
and a stale library is never loaded. :func:`build` starts one ``nvcc`` per
missing source, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'csrc')
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'build', 'dynamask_torch_kernels')

KERNEL_SOURCES = {
    'deform_im2col': 'deform_im2col.cu',
    'deform_col2im': 'deform_col2im.cu',
    'roi_align': 'roi_align.cu',
    'roi_align_bwd': 'roi_align_bwd.cu',
    'deform_conv_fused': 'deform_conv_fused.cu',
}

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v']

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of dynamask_torch '
                       'are built on a machine with the CUDA toolkit')


def library_path(name: str) -> str:
    with open(os.path.join(_CSRC, KERNEL_SOURCES[name]), 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f'lib{name}_{digest.hexdigest()[:12]}.so')


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (all by default) that are not built yet, in
    parallel. Returns ``{name: {'seconds': s, 'log': ptxas output}}`` for the
    ones compiled by this call; raises with nvcc's output on failure."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not os.path.isfile(library_path(n))]
    if not todo:
        return {}
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = [nvcc, *NVCC_FLAGS, '-o', tmp,
               os.path.join(_CSRC, KERNEL_SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    report, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f'nvcc {KERNEL_SOURCES[n]} failed '
                          f'(rc {proc.returncode}):\n{log}')
            continue
        os.replace(tmp, out)
        report[n] = {'seconds': time.perf_counter() - t0, 'log': log}
    if failed:
        raise RuntimeError('\n'.join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
