"""Native (C++) host code of the port, built at first use with g++ and
loaded with ctypes: marching tetrahedra (``march_tets.cpp``).

The library is built into ``.kernel_build/`` at the repository root
(git-ignored), beside the CUDA kernels, never into the package.  Nothing is
built while this module is imported.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from imagesequenceregistrationfor6dposeestimationlabeling_tpu_torch.ops.cuda_build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build() -> str | None:
    src = os.path.join(_HERE, "march_tets.cpp")
    out = os.path.join(BUILD_DIR, "libmarchtets.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """The native library, built if needed; None where it cannot be built."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.march_tets.restype = ctypes.c_int64
        lib.march_tets.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        return _LIB


def march_tets_native(density: np.ndarray, threshold: float):
    """(verts, tris) of the ``density > threshold`` surface, or None where
    the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    density = np.ascontiguousarray(density, np.float32)
    R = density.shape[0]
    cap_v, cap_t = 1 << 20, 1 << 21
    for _ in range(4):
        verts = np.empty((cap_v, 3), np.float32)
        tris = np.empty((cap_t, 3), np.int64)
        n_verts = ctypes.c_int64(0)
        nt = lib.march_tets(
            density.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            R,
            ctypes.c_float(threshold),
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            cap_v,
            cap_t,
            ctypes.byref(n_verts),
        )
        if nt >= 0:
            return verts[: n_verts.value].copy(), tris[:nt].copy()
        cap_v *= 4
        cap_t *= 4
    return None
