"""Elementwise host ELL algebra used by prolongation smoothing and the
evolution strength (counterpart of ``pyamg_tpu/ops/arith.py``: ``scale``,
``scale_rows``, ``scale_cols``, ``add``, ``sub``, ``add_scaled_identity``,
``with_diagonal``, ``remove_diagonal`` and ``filter_rows_by_mask``; setup
phase, numpy)."""

from __future__ import annotations

import dataclasses

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL
from pyamg_tpu_torch.ops.rowops import ell_dedup


def scale(A: ELL, alpha) -> ELL:
    """alpha * A."""
    return ELL(A.cols, A.vals * alpha, A.row_nnz, A.shape)


def scale_rows(A: ELL, d) -> ELL:
    """diag(d) @ A."""
    return ELL(A.cols, A.vals * d[:, None], A.row_nnz, A.shape)


def scale_cols(A: ELL, d) -> ELL:
    """A @ diag(d)."""
    d = np.asarray(d)
    return ELL(A.cols, A.vals * d[A.cols], A.row_nnz, A.shape)


def add(A: ELL, B: ELL, width=None) -> ELL:
    """A + B for conforming ELL matrices (stored entries of both kept)."""
    if A.shape != B.shape:
        raise ValueError(f"shape mismatch {A.shape} vs {B.shape}")
    cols = np.concatenate([A.cols, B.cols], axis=1)
    vals = np.concatenate([A.vals, B.vals], axis=1)
    valid = np.concatenate([A.valid_mask(), B.valid_mask()], axis=1)
    return ell_dedup(cols, vals, valid, A.shape, width=width)


def sub(A: ELL, B: ELL, width=None) -> ELL:
    return add(A, scale(B, -1), width=width)


def _diagonal_slots(A: ELL):
    """(rows, (n, W) bool of the stored diagonal entries)."""
    rows = np.arange(A.shape[0], dtype=np.int32)
    return rows, (A.cols == rows[:, None]) & A.valid_mask()


def add_scaled_identity(A: ELL, alpha=1.0, beta=1.0, width=None) -> ELL:
    """beta * I + alpha * A (square A).  Where every row stores its
    diagonal the pattern is kept as it is; otherwise the diagonal is
    merged in."""
    n = A.shape[0]
    rows, isdiag = _diagonal_slots(A)
    if bool(isdiag.any(axis=1).all()):
        vals = A.vals * alpha + np.where(isdiag, beta, 0)
        return dataclasses.replace(A, vals=vals)
    cols = np.concatenate([A.cols, rows[:, None]], axis=1)
    vals = np.concatenate([A.vals * alpha,
                           np.full((n, 1), beta, dtype=A.vals.dtype)], axis=1)
    valid = np.concatenate([A.valid_mask(), np.ones((n, 1), bool)], axis=1)
    return ell_dedup(cols, vals, valid, A.shape, width=width)


def with_diagonal(A: ELL, d) -> ELL:
    """A with its diagonal replaced (or inserted) by the vector d."""
    rows, isdiag = _diagonal_slots(A)
    d = np.asarray(d)
    if bool(isdiag.any(axis=1).all()):
        return dataclasses.replace(
            A, vals=np.where(isdiag, d[:, None], A.vals))
    cols = np.concatenate([A.cols, rows[:, None]], axis=1)
    vals = np.concatenate([np.where(isdiag, 0, A.vals), d[:, None]], axis=1)
    valid = np.concatenate([A.valid_mask(),
                            np.ones((A.shape[0], 1), bool)], axis=1)
    return ell_dedup(cols, vals, valid, A.shape)


def remove_diagonal(A: ELL) -> ELL:
    """A without its stored diagonal entries."""
    _, isdiag = _diagonal_slots(A)
    return ell_dedup(A.cols, A.vals, A.valid_mask() & ~isdiag, A.shape)


def filter_rows_by_mask(A: ELL, keep) -> ELL:
    """A without the stored entries where the (n, W) mask ``keep`` is
    False, recompacted."""
    return ell_dedup(A.cols, A.vals, np.asarray(keep) & A.valid_mask(),
                     A.shape)
