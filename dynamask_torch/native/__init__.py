"""The port's host-side C code: the COCO RLE mask codec ``maskc.c``.

At first use it is compiled with the system C compiler (``cc``, or ``$CC``)
into a shared library under the checkout's ``build/dynamask_torch_native/``
and loaded with ``ctypes``, as ``ops/_build.py`` builds the CUDA kernels.
The library is named by a hash of its source and flags, so an edited source
is rebuilt and a stale library is never loaded. A failed build raises: the
numpy codec in :mod:`dynamask_torch.data.mask_codec` is the plain version
that the tests hold the C codec against, not a fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, 'maskc.c')
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), 'build',
                          'dynamask_torch_native')
CC_FLAGS = ['-O2', '-shared', '-fPIC', '-std=c99']

_LOCK = threading.Lock()
_LIB: list = []


def _cc() -> str:
    cc = os.environ.get('CC') or shutil.which('cc') or shutil.which('gcc')
    if not cc:
        raise RuntimeError('no C compiler (cc) found: the mask codec of '
                           'dynamask_torch is built with the system compiler')
    return cc


def library_path() -> str:
    with open(_SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(CC_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f'libmaskc_{digest.hexdigest()[:12]}.so')


def build() -> str:
    """Compile ``maskc.c`` unless its library exists; returns its path and
    raises with the compiler's output on failure. The compile writes a
    per-process temporary and lands with an atomic rename, so processes
    that build at once never load a half-written file."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f'{out}.{os.getpid()}.tmp'
    proc = subprocess.run([_cc(), *CC_FLAGS, '-o', tmp, _SOURCE],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f'cc maskc.c failed (rc {proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, vp, cp = ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
    lib.maskc_decode.argtypes = [cp, i64, i64, i64, vp]
    lib.maskc_decode.restype = ctypes.c_int
    lib.maskc_encode.argtypes = [vp, i64, ctypes.POINTER(vp)]
    lib.maskc_encode.restype = i64
    lib.maskc_free.argtypes = [vp]
    lib.maskc_free.restype = None
    lib.maskc_area.argtypes = [cp, i64]
    lib.maskc_area.restype = i64
    lib.maskc_iou.argtypes = [ctypes.POINTER(cp), vp, i64,
                              ctypes.POINTER(cp), vp, i64, vp, vp]
    lib.maskc_iou.restype = ctypes.c_int
    return lib


def maskc() -> ctypes.CDLL:
    """The loaded codec library, built first if needed."""
    with _LOCK:
        if not _LIB:
            _LIB.append(_declare(ctypes.CDLL(build())))
        return _LIB[0]
