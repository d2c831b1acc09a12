"""ctypes loader for the native host-precompute kernels (hostops.cpp).

Compiled lazily with g++ on first use into ``build/native/`` at the root of
the checkout (listed in .gitignore); falls back to NumPy transparently if no
compiler is available. Public entry: ``argsort_rows(rows)`` — a stable
argsort of integer row tuples, the workhorse of GridPlan construction.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build",
    "native",
)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    src = os.path.join(os.path.dirname(__file__), "hostops.cpp")
    so = os.path.join(_BUILD_DIR, "hzt_hostops.so")
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", so, src],
                check=True,
                capture_output=True,
            )
        lib = ctypes.CDLL(so)
        lib.radix_argsort_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mark_group_starts_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def pack_rows(rows: np.ndarray) -> np.ndarray | None:
    """Pack non-negative integer rows into u64 keys preserving lexicographic
    order; None if the values don't fit."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[:, None]
    ncol = rows.shape[1]
    if rows.size == 0:
        return np.zeros(0, dtype=np.uint64)
    hi = int(rows.max()) if rows.size else 0
    bits = max(int(hi).bit_length(), 1)
    if bits * ncol > 64:
        return None
    keys = np.zeros(len(rows), dtype=np.uint64)
    for c in range(ncol):
        keys = (keys << np.uint64(bits)) | rows[:, c].astype(np.uint64)
    return keys


def argsort_rows(rows: np.ndarray) -> np.ndarray:
    """Stable argsort of integer rows (lexicographic). Native radix when the
    rows pack into 64-bit keys, np.lexsort otherwise."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[:, None]
    keys = pack_rows(rows)
    lib = _load()
    if keys is None or lib is None or len(keys) == 0:
        return np.lexsort(rows.T[::-1])
    order = np.empty(len(keys), dtype=np.int64)
    lib.radix_argsort_u64(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(keys),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return order


def native_available() -> bool:
    return _load() is not None
