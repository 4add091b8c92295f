"""ctypes binding for the C++ sparse-precision builder (native/precision.cpp),
with a vectorised NumPy fallback.

Replaces the reference's numba-JIT loops (`examples/spatial/model.py:53-88`).
The shared library is not committed: it is compiled on first use with g++
and cached next to the source (`native/libprecision.so`, listed in
.gitignore); if no toolchain is available the NumPy path is used silently.
"""
import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "native", "precision.cpp")
_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libprecision.so")


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.abspath(_SRC)
        so = os.path.abspath(_SO)
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                # Build beside the target and rename, so a process that
                # races this one never loads a half-written library.
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.precision_count.restype = ctypes.c_int64
            lib.precision_count.argtypes = [ctypes.c_double, ctypes.c_double, ctypes.c_int64]
            lib.precision_fill.restype = None
            lib.precision_fill.argtypes = [
                ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            _LIB = lib
        except (OSError, subprocess.CalledProcessError):
            _LIB = None
        return _LIB


def have_native():
    return _load() is not None


def _coo_native(tau, r_y, d):
    lib = _load()
    n = lib.precision_count(float(tau), float(r_y), int(d))
    data = np.empty(n, dtype=np.float64)
    rows = np.empty(n, dtype=np.int64)
    cols = np.empty(n, dtype=np.int64)
    lib.precision_fill(
        float(tau), float(r_y), int(d),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return data, rows, cols


def _coo_numpy(tau, r_y, d):
    idx = np.arange(d * d)
    ii, jj = idx // d, idx % d
    D = np.abs(ii[:, None] - ii[None, :]) + np.abs(jj[:, None] - jj[None, :])
    mask = D <= r_y
    rows, cols = np.nonzero(mask)
    data = np.power(float(tau), D[rows, cols].astype(np.float64))
    return data, rows.astype(np.int64), cols.astype(np.int64)


def make_precision_coo(tau, r_y, d):
    """(data, rows, cols) of the d^2 x d^2 banded precision with entries
    tau^D for Manhattan distance D <= r_y on the d x d grid."""
    if have_native():
        return _coo_native(tau, r_y, d)
    return _coo_numpy(tau, r_y, d)


def make_precision_dense(tau, r_y, d, dtype=np.float64):
    """Dense d^2 x d^2 precision matrix (for moderate d)."""
    data, rows, cols = make_precision_coo(tau, r_y, d)
    out = np.zeros((d * d, d * d), dtype=dtype)
    out[rows, cols] = data
    return out


def precision_stencil(tau, r_y, dtype=np.float64):
    """The (2r+1) x (2r+1) convolution stencil equivalent to the precision:
    applying the precision to a grid-shaped field is a 2-D convolution with
    this kernel (up to boundary clipping, which conv's zero padding matches
    exactly since out-of-grid entries are absent from the matrix): a dense
    conv instead of a sparse matmul."""
    r = int(r_y)
    di = np.abs(np.arange(-r, r + 1))
    D = di[:, None] + di[None, :]
    stencil = np.power(float(tau), D.astype(np.float64))
    stencil[D > r_y] = 0.0
    return stencil.astype(dtype)
