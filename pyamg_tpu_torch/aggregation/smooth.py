"""Prolongation smoothing (counterpart of ``jacobi_prolongation_smoother``
and ``smooth_prolongator`` in ``pyamg_tpu/aggregation/smooth.py``; setup
phase, numpy): P = (I - omega/rho(D^-1 A) D^-1 A)^degree T."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.ops.arith import scale_rows, sub
from pyamg_tpu_torch.ops.spgemm import spgemm
from pyamg_tpu_torch.ops.spmv import extract_diagonal


def jacobi_prolongation_smoother(S, T, C, B, omega=4.0 / 3.0, degree=1,
                                 filter_entries=False, weighting="diagonal"):
    """Damped-Jacobi prolongation smoothing (reference ``smooth.py:61``)."""
    from pyamg_tpu_torch.relaxation.smoothing import rho_D_inv_A
    d = extract_diagonal(S)
    if weighting == "local":
        # Gershgorin-style local weight: D = |A| row sums
        d = np.sum(np.abs(S.vals), axis=1)
        rho = 1.0
    else:
        rho = rho_D_inv_A(S)
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    DinvS = scale_rows(S, dinv * (omega / rho))
    P = T
    for _ in range(degree):
        P = sub(P, spgemm(DinvS, P))
    return P


def smooth_prolongator(fn_spec, A, T, C, B):
    """Dispatch the ``smooth=`` option: ``'jacobi'`` or None."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    fn, kwargs = unpack_arg(fn_spec)
    if fn == "jacobi":
        return jacobi_prolongation_smoother(A, T, C, B, **kwargs)
    if fn is None:
        return T
    raise NotImplementedError(
        f"prolongation smoother {fn!r} is not ported yet (only 'jacobi')")
