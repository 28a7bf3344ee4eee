"""ctypes loader for the C++ host kernels (native/optconpy_native.cpp).

The port shares the reference's host library unchanged: it is built
lazily with `make -C native` on first use, and when that fails (no
compiler) the numpy path in fem/taylor_hood.py is used instead. Only the
element-matrix entry point is on the port's path so far.
"""
from __future__ import annotations

import ctypes
import functools
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liboptconpy_native.so"


@functools.cache
def load():
    """Return the loaded library, building it if needed; None if that
    fails (no compiler, etc.) — callers then use the numpy path."""
    try:
        if not _LIB_PATH.exists():
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.SubprocessError):
        return None

    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.th_element_matrices.argtypes = [
        f64p, i32p, ctypes.c_int64, f64p, f64p, f64p, f64p,
    ]
    lib.th_element_matrices.restype = None
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def element_matrices(vertices: np.ndarray, triangles: np.ndarray):
    """Native Taylor-Hood element blocks; returns (m_loc, k_loc, j_loc,
    area) with shapes (nt,6,6), (nt,6,6), (nt,3,6,2), (nt,)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int32)
    nt = len(t)
    m_loc = np.empty((nt, 6, 6))
    k_loc = np.empty((nt, 6, 6))
    j_loc = np.empty((nt, 3, 6, 2))
    area = np.empty(nt)
    lib.th_element_matrices(
        _ptr(v, ctypes.c_double), _ptr(t, ctypes.c_int32),
        ctypes.c_int64(nt), _ptr(m_loc, ctypes.c_double),
        _ptr(k_loc, ctypes.c_double), _ptr(j_loc, ctypes.c_double),
        _ptr(area, ctypes.c_double),
    )
    return m_loc, k_loc, j_loc, area
