"""The port's native host helper: first-fit graph coloring.

``coloring.cpp`` is built with ``g++`` at first use (``build.py``) and
loaded with ctypes.  There is no fallback coloring: the colors fix the
Gauss-Seidel iterate, so a missing compiler is an error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np

from .build import shared_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "coloring.cpp")


@functools.cache
def _lib():
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the port builds its graph "
                           "coloring from _native/coloring.cpp")
    path = shared_library(_SRC, [gxx, "-O3", "-shared", "-fPIC",
                                 "-std=c++17"], "coloring")["path"]
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.first_fit_coloring.restype = ctypes.c_int32
    lib.first_fit_coloring.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def first_fit_coloring(n, indptr, indices):
    """Greedy first-fit coloring of a CSR graph: (colors int32, ncolors)."""
    Ap = np.ascontiguousarray(indptr, dtype=np.int32)
    Aj = np.ascontiguousarray(indices, dtype=np.int32)
    if Ap.shape != (n + 1,) or (n and Ap[-1] > Aj.shape[0]):
        raise ValueError("malformed CSR graph")
    colors = np.empty(max(n, 1), np.int32)
    nc = _lib().first_fit_coloring(n, _ptr(Ap), _ptr(Aj), _ptr(colors))
    return colors[:n], int(nc)
