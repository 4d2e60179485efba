"""Elementwise host ELL algebra used by prolongation smoothing
(counterpart of ``scale``/``scale_rows``/``add``/``sub`` in
``pyamg_tpu/ops/arith.py``; setup phase, numpy)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL
from pyamg_tpu_torch.ops.rowops import ell_dedup


def scale(A: ELL, alpha) -> ELL:
    """alpha * A."""
    return ELL(A.cols, A.vals * alpha, A.row_nnz, A.shape)


def scale_rows(A: ELL, d) -> ELL:
    """diag(d) @ A."""
    return ELL(A.cols, A.vals * d[:, None], A.row_nnz, A.shape)


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
