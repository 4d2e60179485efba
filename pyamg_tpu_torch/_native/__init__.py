"""The port's native host helpers: first-fit graph coloring and standard
aggregation.

``coloring.cpp`` and ``aggregation.cpp`` are each built with ``g++`` at
first use (``build.py``) and loaded with ctypes.  There is no fallback:
the colors fix the Gauss-Seidel iterate and the aggregates fix the
hierarchy, so a missing compiler is an error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np

from .build import shared_library

_HERE = os.path.dirname(os.path.abspath(__file__))


# source name -> (its C function, number of int32 buffer arguments)
_FUNCTIONS = {"coloring": ("first_fit_coloring", 3),
              "aggregation": ("standard_aggregation", 4)}


@functools.cache
def _lib(name):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            f"g++ not found: the port builds _native/{name}.cpp")
    path = shared_library(os.path.join(_HERE, f"{name}.cpp"),
                          [gxx, "-O3", "-shared", "-fPIC", "-std=c++17"],
                          name)["path"]
    lib = ctypes.CDLL(path)
    fname, nbuf = _FUNCTIONS[name]
    fn = getattr(lib, fname)
    fn.restype = ctypes.c_int32
    fn.argtypes = [ctypes.c_int32] + [ctypes.POINTER(ctypes.c_int32)] * nbuf
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _csr(n, indptr, indices):
    Ap = np.ascontiguousarray(indptr, dtype=np.int32)
    Aj = np.ascontiguousarray(indices, dtype=np.int32)
    if Ap.shape != (n + 1,) or (n and Ap[-1] > Aj.shape[0]):
        raise ValueError("malformed CSR graph")
    return Ap, Aj


def first_fit_coloring(n, indptr, indices):
    """Greedy first-fit coloring of a CSR graph: (colors int32, ncolors)."""
    Ap, Aj = _csr(n, indptr, indices)
    colors = np.empty(max(n, 1), np.int32)
    nc = _lib("coloring").first_fit_coloring(n, _ptr(Ap), _ptr(Aj),
                                             _ptr(colors))
    return colors[:n], int(nc)


def standard_aggregation(n, indptr, indices):
    """Greedy 3-pass aggregation of a CSR strength graph: (labels int32
    with -1 for isolated nodes, cpts int32 of one root per aggregate)."""
    Ap, Aj = _csr(n, indptr, indices)
    labels = np.empty(max(n, 1), np.int32)
    cpts = np.empty(max(n, 1), np.int32)
    nagg = _lib("aggregation").standard_aggregation(
        n, _ptr(Ap), _ptr(Aj), _ptr(labels), _ptr(cpts))
    return labels[:n], cpts[:nagg]
