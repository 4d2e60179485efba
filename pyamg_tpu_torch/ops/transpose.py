"""Sparse transpose of a host ELL via a global COO sort (setup phase;
counterpart of ``pyamg_tpu/ops/transpose.py:transpose``)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL, ell_from_csr_arrays


def transpose(A: ELL, conjugate: bool = False, width=None) -> ELL:
    n, m = A.shape
    W = A.width
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    rows = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, W))
    vals = np.conj(vals) if conjugate else vals
    # new row = old col; padding gets the row sentinel m and is dropped
    t_rows = np.where(A.valid_mask(), cols, m).reshape(-1)
    t_cols = rows.reshape(-1).copy()
    t_vals = vals.reshape(-1)
    keep = t_rows < m
    t_rows, t_cols, t_vals = t_rows[keep], t_cols[keep], t_vals[keep]
    order = np.lexsort((t_cols, t_rows))
    t_rows, t_cols, t_vals = t_rows[order], t_cols[order], t_vals[order]
    counts = np.bincount(t_rows, minlength=m).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return ell_from_csr_arrays(indptr, t_cols, t_vals, (m, n), width=width)
