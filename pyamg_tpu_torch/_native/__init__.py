"""The port's native host helpers: first-fit graph coloring, standard and
naive aggregation and the classical (Ruge-Stuben) setup.

``coloring.cpp``, ``aggregation.cpp`` and ``classical.cpp`` are each built
with ``g++`` at first use (``build.py``) and loaded with ctypes.  There is
no fallback: the colors fix the Gauss-Seidel iterate, and the aggregates,
the C/F splitting and the interpolation weights fix the hierarchy, so a
missing compiler is an error.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np

from .build import shared_library

_HERE = os.path.dirname(os.path.abspath(__file__))


_I = ctypes.c_int32
_IP = ctypes.POINTER(ctypes.c_int32)
_FP = ctypes.POINTER(ctypes.c_double)

# source name -> {C function: (restype, argtypes)}
_FUNCTIONS = {
    "coloring": {"first_fit_coloring": (_I, [_I, _IP, _IP, _IP])},
    "aggregation": {"standard_aggregation": (_I, [_I, _IP, _IP, _IP, _IP]),
                    "naive_aggregation": (_I, [_I, _IP, _IP, _IP, _IP])},
    "classical": {
        "rs_cf_splitting": (None, [_I, _IP, _IP, _IP, _IP, _IP, _IP]),
        "rs_cf_splitting_pass2": (None, [_I, _IP, _IP, _IP]),
        "remove_strong_ff_ell": (None, [_I, _I, _IP, _FP, _IP, _IP, _IP]),
        "classical_interpolation_ell": (
            None, [_I, _I, _IP, _FP, _IP, _I, _IP, _FP, _IP, _IP, _IP, _I,
                   _I, _IP, _FP, _IP])},
}


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
    for fname, (restype, argtypes) in _FUNCTIONS[name].items():
        fn = getattr(lib, fname)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _ptr(a):
    return a.ctypes.data_as(_IP)


def _fptr(a):
    return a.ctypes.data_as(_FP)


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


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


def _aggregate(fname, n, indptr, indices):
    Ap, Aj = _csr(n, indptr, indices)
    labels = np.empty(max(n, 1), np.int32)
    cpts = np.empty(max(n, 1), np.int32)
    nagg = getattr(_lib("aggregation"), fname)(
        n, _ptr(Ap), _ptr(Aj), _ptr(labels), _ptr(cpts))
    return labels[:n], cpts[:nagg]


def standard_aggregation(n, indptr, indices):
    """Greedy 3-pass aggregation of a CSR strength graph: (labels int32
    with -1 for isolated nodes, cpts int32 of one root per aggregate)."""
    return _aggregate("standard_aggregation", n, indptr, indices)


def naive_aggregation(n, indptr, indices):
    """Greedy naive aggregation of a CSR strength graph (each free node
    roots an aggregate of itself and its free neighbours): (labels int32,
    cpts int32 of one root per aggregate)."""
    return _aggregate("naive_aggregation", n, indptr, indices)


def rs_cf_splitting(n, Sp, Sj, Tp, Tj, second_pass=False):
    """Ruge-Stuben splitting (1 = C, 0 = F) of the strength graph S in CSR
    (``Sp``, ``Sj``) with its transpose (``Tp``, ``Tj``); with
    ``second_pass``, strong F-F pairs without a common C point are
    repaired."""
    Sp, Sj = _csr(n, Sp, Sj)
    Tp, Tj = _csr(n, Tp, Tj)
    influence = np.zeros(max(n, 1), np.int32)
    out = np.empty(max(n, 1), np.int32)
    lib = _lib("classical")
    lib.rs_cf_splitting(n, _ptr(Sp), _ptr(Sj), _ptr(Tp), _ptr(Tj),
                        _ptr(influence), _ptr(out))
    if second_pass:
        lib.rs_cf_splitting_pass2(n, _ptr(Sp), _ptr(Sj), _ptr(out))
    return out[:n]


def _square_ell(cols, vals, nnz, n):
    """int32 cols, float64 vals and int32 row counts of an (n, W) ELL whose
    columns lie in [0, n), as the native loops index by column."""
    cols, vals, nnz = _i32(cols), _f64(vals), _i32(nnz)
    if cols.ndim != 2 or cols.shape[0] != n or vals.shape != cols.shape or \
            nnz.shape != (n,) or (cols.size and (cols.min() < 0 or
                                                 cols.max() >= n)) or \
            (n and (nnz.min() < 0 or nnz.max() > cols.shape[1])):
        raise ValueError("malformed square ELL arrays")
    return cols, vals, nnz


def remove_strong_ff_ell(s_cols, s_vals, s_nnz, split):
    """(n, Ws) bool: the strong F-F entries of the ELL strength arrays
    whose two points share no strong C point."""
    n, Ws = s_cols.shape
    sc, sv, sn = _square_ell(s_cols, s_vals, s_nnz, n)
    sp = _i32(split)
    if sp.shape != (n,):
        raise ValueError("the splitting must have one entry a row")
    drop = np.empty((n, Ws), np.int32)
    _lib("classical").remove_strong_ff_ell(n, Ws, _ptr(sc), _fptr(sv),
                                           _ptr(sn), _ptr(sp), _ptr(drop))
    return drop.astype(bool)


def classical_interpolation_ell(a_cols, a_vals, a_nnz, s_cols, s_vals,
                                s_nnz, split, cmap, modified, Wp):
    """(p_cols, p_vals float64, p_nnz): padded ELL arrays of width ``Wp``
    of the (modified) classical interpolation of A over the strength
    pattern S."""
    n, Wa = a_cols.shape
    Ws = s_cols.shape[1]
    ac, av, an = _square_ell(a_cols, a_vals, a_nnz, n)
    sc, sv, sn = _square_ell(s_cols, s_vals, s_nnz, n)
    sp, cm = _i32(split), _i32(cmap)
    if sp.shape != (n,) or cm.shape != (n,):
        raise ValueError("the splitting and coarse map must have one entry "
                         "a row")
    Wp = max(int(Wp), 1)
    p_cols = np.zeros((n, Wp), np.int32)
    p_vals = np.zeros((n, Wp), np.float64)
    p_nnz = np.zeros((n,), np.int32)
    _lib("classical").classical_interpolation_ell(
        n, Wa, _ptr(ac), _fptr(av), _ptr(an), Ws, _ptr(sc), _fptr(sv),
        _ptr(sn), _ptr(sp), _ptr(cm), int(bool(modified)), Wp,
        _ptr(p_cols), _fptr(p_vals), _ptr(p_nnz))
    return p_cols, p_vals, p_nnz
