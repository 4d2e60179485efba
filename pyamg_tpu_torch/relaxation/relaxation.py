"""Multicolor Gauss-Seidel (counterpart of ``make_coloring`` and
``gauss_seidel`` in ``pyamg_tpu/relaxation/relaxation.py``).

Nodes are grouped into independent sets by a graph coloring at setup,
and each color is updated at once: exact Gauss-Seidel with respect to
the colored ordering.  Host (numpy) operands are the setup phase
(candidate improvement); tensor operands are the solve phase, where a
DIA operator takes kernel K2 (``ops/dia_kernels.dia_gs_sweep``).  A SELL
operator takes the hybrid sweep K5 (``ops/sell_kernels.sell_gs_sweep``)
instead: 1024-row tiles in order, Gauss-Seidel across tiles and Jacobi
within one; it ignores the colors.
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import DIA, ELL
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops.spmv import extract_diagonal, matvec
from pyamg_tpu_torch.ops import dia_kernels, sell_kernels


def dinv_vec(A):
    """1 / diag(A), with 0 where the diagonal is 0."""
    d = extract_diagonal(A)
    if isinstance(d, torch.Tensor):
        return torch.where(d != 0, 1.0 / torch.where(d == 0, 1, d), 0.0)
    return np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)


def make_coloring(A: ELL):
    """(colors int32 (n,), ncolors) of the graph of a host ELL: the
    sequential first-fit coloring of the port's native helper."""
    from pyamg_tpu_torch import _native
    if not isinstance(A, ELL) or isinstance(A.cols, torch.Tensor):
        raise NotImplementedError(
            "coloring takes a host ELL; the parallel (JP) coloring of other "
            "containers is not ported yet")
    n = A.shape[0]
    row_nnz = np.asarray(A.row_nnz)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int32)
    indices = np.asarray(A.cols)[A.valid_mask()].astype(np.int32)
    return _native.first_fit_coloring(n, indptr, indices)


def gs_order(ncolors, sweep="forward", iterations=1, omega=1.0):
    """The color-pass sequence of a multicolor GS call.  With omega = 1 a
    pass leaves its rows' residuals at (roundoff) zero, so an immediately
    repeated color is a no-op and is dropped: symmetric (0,1)+(1,0)
    becomes (0,1,0)."""
    fwd = list(range(int(ncolors)))
    if sweep == "forward":
        seq = fwd
    elif sweep == "backward":
        seq = fwd[::-1]
    elif sweep == "symmetric":
        seq = fwd + fwd[::-1]
    else:
        raise ValueError(f"unknown sweep {sweep!r}")
    order = seq * int(iterations)
    if float(omega) == 1.0 and len(order) > 1:
        order = [order[0]] + [c for i, c in enumerate(order[1:])
                              if c != order[i]]
    return order


def gauss_seidel(A, x, b, iterations=1, sweep="forward", colors=None,
                 ncolors=None, Dinv=None, omega=1.0):
    """Multicolor Gauss-Seidel/SOR: per color c of the pass order, every
    row i of color c gets x_i += omega * (b_i - (A x)_i) / a_ii.
    ``sweep``: 'forward', 'backward' (reverse color order) or
    'symmetric'.  On a SELL operator: ``iterations`` hybrid sweeps."""
    if isinstance(A, SELL):
        Dinv = dinv_vec(A) if Dinv is None else Dinv
        for _ in range(iterations):
            x = sell_kernels.sell_gs_sweep(A, x, b, Dinv, omega, sweep)
        return x
    if colors is None:
        colors, ncolors = make_coloring(A)
    order = gs_order(ncolors, sweep, iterations, omega)
    Dinv = dinv_vec(A) if Dinv is None else Dinv
    if isinstance(A, DIA) and isinstance(x, torch.Tensor):
        return dia_kernels.dia_gs_sweep(A.data, A.offsets, A.shape[0], x, b,
                                        Dinv, colors, order, omega)
    if isinstance(x, torch.Tensor):
        where = torch.where
    else:
        x, b = np.asarray(x), np.asarray(b)
        Dinv, colors = np.asarray(Dinv), np.asarray(colors)
        where = np.where
    Dinvb = Dinv[:, None] if x.ndim == 2 else Dinv
    for c in order:
        upd = x + omega * Dinvb * (b - matvec(A, x))
        m = colors == c
        x = where(m[:, None] if x.ndim == 2 else m, upd, x)
    return x
