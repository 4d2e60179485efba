"""Shared Krylov plumbing (counterpart of ``pyamg_tpu/krylov/common.py``).

Every method has the interface ``(A, b, x0=None, tol=1e-5, criteria='rr',
maxiter=None, M=None, callback=None, residuals=None, device=None) ->
(x, info)``: ``info`` is 0 on convergence, the iteration count when
``maxiter`` ran out and negative on a breakdown.  The iteration is a
Python loop over tensor ops; every scalar stays on the device and the
host reads one stop flag per iteration.

Placement: a tensor or an operator already placed (``.to(device)``)
stays where it is, and b and x0 follow it.  A host array or host
operator (numpy, scipy sparse, a host ELL/BELL/DIA/SELL) goes to
``device``, by default the card; nothing falls back to the CPU by itself
(``pyamg_tpu_torch/_device.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.sparse.matrix import (BELL, DIA, ELL, PhaseStencil,
                                           from_scipy)
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops.spmv import matvec as sp_matvec
from pyamg_tpu_torch.parallel.partition import sharded_mesh

CONTAINERS = (DIA, ELL, BELL, PhaseStencil, SELL)


def real_dtype(dtype):
    """The real dtype residual norms live in for value dtype ``dtype``."""
    return torch.empty((), dtype=dtype).real.dtype


def dot(a, b):
    """<conj(a), b>."""
    return torch.vdot(a, b)


def norm(v):
    return torch.sqrt(torch.real(torch.vdot(v, v)))


def dots(V, u):
    """V^H u: the inner products of u with the rows of V."""
    return (V.conj() if V.is_complex() else V) @ u


class Reduction(NamedTuple):
    """The inner products a Krylov loop takes: ``dot(a, b)``, ``norm(v)``
    and ``dots(V, u)``.  ``LOCAL`` is the plain one; a row-sharded level
    sums each over the ranks (``parallel.partition.ShardedReduction``)."""
    dot: Callable
    norm: Callable
    dots: Callable


LOCAL = Reduction(dot, norm, dots)


def reduction(A):
    """The inner products of the vectors A acts on: summed over the ranks
    where A is row-sharded, else ``LOCAL``."""
    mesh = sharded_mesh(A)
    return LOCAL if mesh is None else mesh.reduction


def torch_dtype(dtype):
    """A numpy or torch dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype)).dtype


def placed_device(A):
    """The device an operator or tensor lives on, None for host data."""
    if isinstance(A, torch.Tensor):
        return A.device
    arr = {DIA: "data", ELL: "vals", BELL: "vals",
           SELL: "vals"}.get(type(A))
    if arr is not None:
        v = getattr(A, arr)
        return v.device if isinstance(v, torch.Tensor) else None
    if isinstance(A, PhaseStencil):
        v = A.arrays[0]
        return v.device if isinstance(v, torch.Tensor) else None
    return None


def place(A, device=None):
    """(A placed, its device): a placed operator or tensor stays; host
    data goes to ``device`` (default the card)."""
    import scipy.sparse as sp
    dev = placed_device(A)
    if dev is not None:
        return A, dev
    if callable(getattr(A, "matvec", None)) or callable(A):
        return A, None
    if sp.issparse(A):
        A = from_scipy(A)
    dev = resolve("cuda" if device is None else device)
    if isinstance(A, CONTAINERS):
        return A.to(dev), dev
    return as_tensor(np.asarray(A), dev), dev


def _frobenius(v):
    return lambda: torch.sqrt(torch.sum(torch.abs(v) ** 2))


def as_matvec(A):
    """(matvec, n, dtype, ||A||_F function or None) of a placed operator,
    a dense tensor or an object with ``matvec``, ``shape`` and
    ``dtype``."""
    if isinstance(A, (ELL, SELL)):
        return (lambda v: sp_matvec(A, v)), A.shape[0], A.dtype, \
            _frobenius(A.vals)
    if isinstance(A, DIA):
        return (lambda v: sp_matvec(A, v)), A.shape[0], A.dtype, \
            _frobenius(A.data)
    if isinstance(A, PhaseStencil):
        return (lambda v: sp_matvec(A, v)), A.shape[0], A.dtype, None
    if callable(getattr(A, "matvec", None)):
        return A.matvec, A.shape[0], getattr(A, "dtype", None), \
            getattr(A, "fro", None)
    if callable(A):
        raise TypeError("pass a LinearOperator-like with .shape, not a bare "
                        "callable")
    return (lambda v: A @ v), A.shape[0], A.dtype, _frobenius(A)


def as_precond(M, device=None):
    """M as a function v -> M v (identity for None); a host operator or
    array goes to ``device``."""
    if M is None:
        return lambda v: v
    if callable(getattr(M, "matvec", None)):
        return M.matvec
    if callable(M) and not isinstance(M, CONTAINERS):
        return M
    M, _ = place(M, device)
    if isinstance(M, CONTAINERS):
        return lambda v: sp_matvec(M, v)
    return lambda v: M @ v


def prepare(A, b, x0, maxiter, device=None):
    """(A placed, matvec, n, ||A||_F function, b, x, maxiter): b and x0 as
    vectors of A's dtype on A's device (for an object with ``matvec``: on
    ``device``, else b's, else the card); ``maxiter`` defaults to
    min(max(1.3 n, 5), 10000)."""
    A, dev = place(A, device)
    mv, n, dtype, fro = as_matvec(A)
    if dev is None:
        dev = b.device if isinstance(b, torch.Tensor) and device is None \
            else resolve("cuda" if device is None else device)
    if dtype is None:
        dtype = b.dtype if isinstance(b, torch.Tensor) else \
            torch_dtype(np.asarray(b).dtype)
    dtype = torch_dtype(dtype)
    b = as_tensor(b, dev, dtype).reshape(-1)
    x = torch.zeros_like(b) if x0 is None else \
        as_tensor(x0, dev, dtype).reshape(-1)
    if maxiter is None:
        maxiter = int(min(max(1.3 * n, 5), 10000))
    return A, mv, n, fro, b, x, int(maxiter)


def finalize(residuals, resbuf, nres):
    """Copy the first ``nres`` entries of ``resbuf`` into ``residuals``."""
    if residuals is not None:
        residuals[:] = resbuf[:int(nres)].tolist()


def final_info(info, it, maxiter, done):
    """``info`` as an int: the iteration count where the loop ran out of
    iterations without a verdict (one host read)."""
    if not done and it >= maxiter:
        info = torch.where(info == 0, it, info)
    return int(info)
