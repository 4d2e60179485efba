"""Strength of connection (counterpart of ``pyamg_tpu/strength.py``;
setup phase, numpy).

Returned S has each row scaled so its largest entry is 1, diagonal always
kept; S[i, j] != 0 means i is strongly influenced by j.  A block (BELL)
operator is measured on its block graph: its blocks reduced to scalars
(``_block_reduce``).
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL
from pyamg_tpu_torch.ops.rowops import ell_dedup


def _scale_rows_by_largest_entry(vals, valid):
    mx = np.max(np.where(valid, np.abs(vals), 0), axis=1, keepdims=True)
    return np.where(mx > 0, vals / np.where(mx == 0, 1, mx), vals)


def _block_reduce(A: BELL, norm="abs"):
    """The node-level ELL of a BELL: each block reduced to its largest
    magnitude (``'abs'``), its minimum (``'min'``) or its squared
    Frobenius norm (``'fro'``); values below 1e-16 in magnitude become 0."""
    vals = np.asarray(A.vals)
    if norm == "abs":
        data = np.max(np.abs(vals), axis=(2, 3))
    elif norm == "min":
        data = np.min(vals, axis=(2, 3))
    elif norm == "fro":
        data = np.sum(np.abs(vals) ** 2, axis=(2, 3))
    else:
        raise ValueError("invalid norm")
    data = np.where(np.abs(data) < 1e-16, 0.0, data)
    return ELL(A.cols, data, A.row_nnz, (A.n_block_rows, A.n_block_cols))


def symmetric_strength_of_connection(A, theta=0):
    """|A_ij| >= theta*sqrt(|A_ii A_jj|); diagonal kept (reference
    ``strength.py:248`` / ``smoothed_aggregation.h:56``).  A BELL is
    measured on its blocks' squared Frobenius norms; with theta 0 its
    strength is its block pattern."""
    if theta < 0:
        raise ValueError("expected a positive theta")
    if isinstance(A, BELL):
        if theta == 0:
            return ELL(A.cols, np.where(A.valid_mask(), 1.0, 0.0), A.row_nnz,
                       (A.n_block_rows, A.n_block_cols))
        A = _block_reduce(A, "fro")
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    valid = A.valid_mask()
    isdiag = cols == np.arange(n, dtype=np.int32)[:, None]
    dn = np.abs(np.sum(np.where(isdiag & valid, vals, 0), axis=1))
    thresh = (theta * theta) * dn[:, None] * dn[cols]
    keep = valid & ((np.abs(vals) ** 2 >= thresh) | isdiag)
    svals = _scale_rows_by_largest_entry(np.abs(vals), keep)
    return ell_dedup(cols, np.where(keep, svals, 0), keep, A.shape)


def classical_strength_of_connection(A, theta=0.1, block=True, norm="abs"):
    """|A_ij| >= theta * max_k!=i |A_ik| (``'abs'``, ``'fro'``) or
    -A_ij >= theta * max_k!=i (-A_ik) (``'min'``), compared in A's dtype;
    diagonal always kept (reference ``strength.py:114`` /
    ``ruge_stuben.h:64``).  A BELL is measured on its blocks reduced by
    ``norm`` (``'abs'`` for any other), whatever ``block`` says, as in the
    reference."""
    if isinstance(A, BELL):
        A = _block_reduce(A, norm if norm in ("abs", "min", "fro")
                          else "abs")
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    valid = A.valid_mask()
    offd = valid & (cols != np.arange(n, dtype=np.int32)[:, None])
    if norm in ("abs", "fro"):
        mag = np.abs(vals)
        mx = np.max(np.where(offd, mag, 0), axis=1, keepdims=True)
        keep = offd & (mag >= theta * mx)
    elif norm == "min":
        neg = -np.real(vals)
        mx = np.max(np.where(offd, neg, -np.inf), axis=1, keepdims=True)
        keep = offd & (neg >= theta * mx) & (mx > 0)
    else:
        raise ValueError("unrecognized norm")
    keep = keep | (valid & ~offd)          # always keep the diagonal
    svals = _scale_rows_by_largest_entry(np.abs(vals), keep)
    return ell_dedup(cols, np.where(keep, svals, 0), keep, A.shape)


def strength_measure(A, spec):
    """Dispatch PyAMG's ``(name, opts)`` strength convention: ``None``
    (the |A| pattern; a BELL's blocks by their largest magnitude),
    ``'symmetric'``, ``'classical'`` or ``'evolution'``/``'ode'``."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = (None, {}) if spec is None else unpack_arg(spec)
    if name is None:
        if isinstance(A, BELL):
            return _block_reduce(A, "abs")
        return ELL(A.cols, np.abs(A.vals), A.row_nnz, A.shape)
    if name == "symmetric":
        return symmetric_strength_of_connection(A, **opts)
    if name == "classical":
        return classical_strength_of_connection(A, **opts)
    if name in ("evolution", "ode"):
        from pyamg_tpu_torch.strength_evolution import (
            evolution_strength_of_connection)
        return evolution_strength_of_connection(A, **opts)
    if name in ("distance", "energy_based", "affinity", "algebraic_distance"):
        raise NotImplementedError(
            f"strength {name!r} is not ported yet (only 'symmetric', "
            f"'classical', 'evolution' and None)")
    raise ValueError(f"unrecognized strength of connection method {name!r}")
