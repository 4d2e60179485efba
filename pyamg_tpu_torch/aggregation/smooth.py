"""Prolongation smoothing (counterpart of ``jacobi_prolongation_smoother``,
``richardson_prolongation_smoother`` and ``smooth_prolongator`` in
``pyamg_tpu/aggregation/smooth.py``; setup phase, numpy):
P = (I - omega/rho(D^-1 A) D^-1 A)^degree T, or (I - omega/rho(A) A)^degree
T.  A block (BELL) operator with a block T scales by its pseudo-inverted
diagonal blocks.  Energy minimisation lives in ``energy.py``."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL
from pyamg_tpu_torch.ops.arith import scale, scale_rows, sub
from pyamg_tpu_torch.ops.spgemm import spgemm, spgemm_bell
from pyamg_tpu_torch.ops.spmv import extract_block_diagonal, extract_diagonal
from pyamg_tpu_torch.util.linalg import approximate_spectral_radius, \
    pinv_array


def _bell_scale_rows_blockdiag(A: BELL, Dinv):
    """blockdiag(Dinv) @ A (Dinv: (nb, br, br))."""
    return BELL(A.cols, np.einsum("nij,nwjk->nwik", Dinv, A.vals),
                A.row_nnz, A.shape, A.blocksize)


def _bell_sub(X: BELL, Y: BELL) -> BELL:
    """X - Y for conforming BELLs: the union of their block patterns, each
    row's blocks in column order, the blocks of a column summed."""
    if X.shape != Y.shape or X.blocksize != Y.blocksize:
        raise ValueError("X and Y do not conform")
    nb, (br, bc) = X.n_block_rows, X.blocksize
    cols = np.concatenate([X.cols, Y.cols], axis=1)
    vals = np.concatenate([X.vals, -Y.vals], axis=1)
    valid = np.concatenate([X.valid_mask(), Y.valid_mask()], axis=1)
    rows = np.broadcast_to(np.arange(nb)[:, None], cols.shape)[valid]
    key = rows.astype(np.int64) * X.n_block_cols + cols[valid]
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), br, bc), vals.dtype)
    np.add.at(blocks, inv.reshape(-1), vals[valid])
    urows = uniq // X.n_block_cols
    row_nnz = np.bincount(urows, minlength=nb).astype(np.int32)
    width = max(int(row_nnz.max()) if nb else 0, 1)
    offs = np.arange(len(uniq)) - np.repeat(
        np.concatenate([[0], np.cumsum(row_nnz)[:-1]]), row_nnz)
    out_cols = np.zeros((nb, width), np.int32)
    out_vals = np.zeros((nb, width, br, bc), vals.dtype)
    out_cols[urows, offs] = uniq % X.n_block_cols
    out_vals[urows, offs] = blocks
    return BELL(out_cols, out_vals, row_nnz, X.shape, X.blocksize)


def jacobi_prolongation_smoother(S, T, C, B, omega=4.0 / 3.0, degree=1,
                                 filter_entries=False, weighting="diagonal"):
    """Damped-Jacobi prolongation smoothing (reference ``smooth.py:61``).
    ``weighting='local'`` damps a scalar operator by its |A| row sums
    instead of omega / rho(D^-1 A).  ``filter_entries`` is accepted and
    not used, as in the reference."""
    from pyamg_tpu_torch.relaxation.smoothing import rho_D_inv_A
    if isinstance(T, BELL) and not isinstance(S, BELL):
        # a scalar operator with several candidates: S as 1 x 1 blocks,
        # so that the block product conforms with T's (1, K2) blocks
        S = BELL(S.cols, S.vals[:, :, None, None], S.row_nnz, S.shape,
                 (1, 1))
    if isinstance(S, BELL) and isinstance(T, BELL):
        Dinv = pinv_array(extract_block_diagonal(S))
        DinvS = _bell_scale_rows_blockdiag(S, Dinv * (omega / rho_D_inv_A(S)))
        P = T
        for _ in range(degree):
            P = _bell_sub(P, spgemm_bell(DinvS, P))
        return P
    if isinstance(S, BELL):
        from pyamg_tpu_torch.strength import _block_reduce
        S = _block_reduce(S, "abs")
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


def richardson_prolongation_smoother(S, T, omega=4.0 / 3.0, degree=1):
    """Richardson prolongation smoothing (reference ``smooth.py:209``):
    P = (I - omega / rho(S) S)^degree T."""
    if isinstance(T, BELL) and not isinstance(S, BELL):
        S = BELL(S.cols, S.vals[:, :, None, None], S.row_nnz, S.shape,
                 (1, 1))
    w = omega / approximate_spectral_radius(S)
    if isinstance(S, BELL) and isinstance(T, BELL):
        Sw = BELL(S.cols, S.vals * w, S.row_nnz, S.shape, S.blocksize)
        P = T
        for _ in range(degree):
            P = _bell_sub(P, spgemm_bell(Sw, P))
        return P
    Sw = scale(S, w)
    P = T
    for _ in range(degree):
        P = sub(P, spgemm(Sw, P))
    return P


def smooth_prolongator(fn_spec, A, T, C, B):
    """Dispatch the ``smooth=`` option: ``'jacobi'``, ``'richardson'``,
    ``'energy'`` or None."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    fn, kwargs = unpack_arg(fn_spec)
    if fn == "jacobi":
        return jacobi_prolongation_smoother(A, T, C, B, **kwargs)
    if fn == "richardson":
        return richardson_prolongation_smoother(A, T, **kwargs)
    if fn == "energy":
        from pyamg_tpu_torch.aggregation.energy import (
            energy_prolongation_smoother)
        return energy_prolongation_smoother(A, T, C, B, None, (False, {}),
                                            **kwargs)
    if fn is None:
        return T
    raise ValueError(f"unrecognized prolongation smoother {fn!r}")
