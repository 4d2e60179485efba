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


def distance_strength_of_connection(A, V, theta=2.0, relative_drop=True):
    """Strength from the coordinates V of the nodes: keep the entries whose
    Euclidean distance is at most theta times the row's shortest
    (``relative_drop``) or at most theta, strength 1 / distance, rows
    scaled by their largest (reference ``strength.py:24``).  A BELL is
    measured on its block graph."""
    base = _block_reduce(A, "abs") if isinstance(A, BELL) else A
    V = np.asarray(V)
    cols = np.asarray(base.cols)
    valid = base.valid_mask()
    d = np.sqrt(np.sum((V[cols] - V[:, None, :]) ** 2, axis=-1))
    isdiag = cols == np.arange(base.shape[0], dtype=np.int32)[:, None]
    offd = valid & ~isdiag
    if relative_drop:
        mn = np.min(np.where(offd, d, np.inf), axis=1, keepdims=True)
        keep = offd & (d <= theta * mn)
    else:
        keep = offd & (d <= theta)
    keep = keep | (valid & isdiag)
    with np.errstate(divide="ignore"):
        vals = np.where(d > 0, 1.0 / np.where(d == 0, 1, d), 1.0)
    vals = _scale_rows_by_largest_entry(vals, keep)
    return ell_dedup(cols, np.where(keep, vals, 0), keep, base.shape)


def energy_based_strength_of_connection(A, theta=0.0, k=2):
    """Strength from ``k`` Jacobi steps on the identity: ``|(I - D^-1
    A)^k|``, entries above theta and the diagonal kept, rows scaled by
    their largest (reference ``strength.py:358``).  A BELL is measured on
    its block graph."""
    from pyamg_tpu_torch.ops.arith import add_scaled_identity, scale_rows
    from pyamg_tpu_torch.ops.spgemm import spgemm
    from pyamg_tpu_torch.ops.spmv import extract_diagonal
    if isinstance(A, BELL):
        A = _block_reduce(A, "abs")
    d = extract_diagonal(A)
    dinv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    S = add_scaled_identity(scale_rows(A, dinv), alpha=-1.0, beta=1.0)
    M = S
    for _ in range(k - 1):
        M = spgemm(M, S)
    cols = np.asarray(M.cols)
    valid = M.valid_mask()
    vals = np.abs(M.vals)
    isdiag = cols == np.arange(M.shape[0], dtype=np.int32)[:, None]
    keep = (valid & (vals > theta)) | (valid & isdiag)
    vals = _scale_rows_by_largest_entry(vals, keep)
    return ell_dedup(cols, np.where(keep, vals, 0), keep, M.shape)


def _test_vectors(A, alpha, R, k, seed=0):
    """(scalar A, X): R random vectors from ``seed`` relaxed by k Jacobi
    steps (omega ``alpha``) on A X = 0 (reference
    ``strength.py:895-1070``)."""
    from pyamg_tpu_torch.relaxation.relaxation import jacobi
    if isinstance(A, BELL):
        A = _block_reduce(A, "abs")
    rng = np.random.default_rng(seed)
    X = (rng.random((A.shape[0], R)) * 2 - 1).astype(A.vals.dtype)
    return A, jacobi(A, X, np.zeros_like(X), iterations=k, omega=alpha)


def affinity_distance(A, alpha=0.5, R=5, k=20, epsilon=4.0, seed=0):
    """Affinity strength (reference ``strength.py:953``): the distance
    ``1 - <x_i, x_j>^2 / (|x_i|^2 |x_j|^2)`` over R relaxed test vectors,
    filtered by ``_distance_filter``."""
    A2, X = _test_vectors(A, alpha, R, k, seed)
    cols = np.asarray(A2.cols)
    Xi, Xj = X[:, None, :], X[cols]
    num = np.abs(np.sum(Xi * Xj, axis=-1)) ** 2
    den = np.sum(Xi * Xi, axis=-1) * np.sum(Xj * Xj, axis=-1)
    d = 1.0 - num / np.where(den == 0, 1, den) + 1e-16
    return _distance_filter(A2, d, epsilon)


def algebraic_distance(A, alpha=0.5, R=5, k=20, p=2, epsilon=2.0, seed=0):
    """Algebraic-distance strength (reference ``strength.py:1019``): the
    p-mean (or max, p = inf) of |x_i - x_j| over R relaxed test vectors,
    filtered by ``_distance_filter``."""
    A2, X = _test_vectors(A, alpha, R, k, seed)
    diff = np.abs(X[:, None, :] - X[np.asarray(A2.cols)])
    if p == np.inf:
        d = np.max(diff, axis=-1)
    else:
        d = (np.sum(diff ** p, axis=-1) / diff.shape[-1]) ** (1.0 / p)
    return _distance_filter(A2, d + 1e-16, epsilon)


def _distance_filter(A, d, epsilon):
    """Keep the entries within epsilon times the row's shortest distance
    and the diagonal; strength 1 / distance, rows scaled by their
    largest."""
    cols = np.asarray(A.cols)
    valid = A.valid_mask()
    isdiag = cols == np.arange(A.shape[0], dtype=np.int32)[:, None]
    offd = valid & ~isdiag
    mn = np.min(np.where(offd, d, np.inf), axis=1, keepdims=True)
    keep = (offd & (d <= epsilon * mn)) | (valid & isdiag)
    with np.errstate(divide="ignore"):
        vals = _scale_rows_by_largest_entry(1.0 / d, keep)
    return ell_dedup(cols, np.where(keep, vals, 0), keep, A.shape)


_MEASURES = {
    "symmetric": symmetric_strength_of_connection,
    "classical": classical_strength_of_connection,
    "distance": distance_strength_of_connection,
    "energy_based": energy_based_strength_of_connection,
    "affinity": affinity_distance,
    "algebraic_distance": algebraic_distance,
}


def strength_measure(A, spec, default=("symmetric", {})):
    """Dispatch PyAMG's ``(name, opts)`` strength convention: ``None``
    (the |A| pattern; a BELL's blocks by their largest magnitude),
    ``'symmetric'``, ``'classical'``, ``'distance'``,
    ``'evolution'``/``'ode'``, ``'energy_based'``, ``'affinity'`` or
    ``'algebraic_distance'``.  ``default`` is accepted and unused, as in
    the reference."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = (None, {}) if spec is None else unpack_arg(spec)
    if name is None:
        if isinstance(A, BELL):
            return _block_reduce(A, "abs")
        return ELL(A.cols, np.abs(A.vals), A.row_nnz, A.shape)
    if name in ("evolution", "ode"):
        from pyamg_tpu_torch.strength_evolution import (
            evolution_strength_of_connection)
        return evolution_strength_of_connection(A, **opts)
    if name in _MEASURES:
        return _MEASURES[name](A, **opts)
    raise ValueError(f"unrecognized strength of connection method {name!r}")
