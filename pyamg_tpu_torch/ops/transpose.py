"""Sparse transpose of a host ELL or BELL via a global COO sort (setup
phase; counterpart of ``transpose`` and ``btranspose`` in
``pyamg_tpu/ops/transpose.py``)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL, ell_from_csr_arrays


def _coo_transposed(cols, row_nnz, n, m):
    """(new rows, new cols, order of the stored entries, counts per new
    row) of the transpose of an (n x m) padded-row pattern: the stored
    entries sorted by (old column, old row)."""
    W = cols.shape[1]
    rows = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, W))
    valid = np.arange(W)[None, :] < np.asarray(row_nnz)[:, None]
    # new row = old col; padding gets the row sentinel m and is dropped
    t_rows = np.where(valid, np.asarray(cols), m).reshape(-1)
    t_cols = rows.reshape(-1).copy()
    keep = np.flatnonzero(t_rows < m)
    t_rows, t_cols = t_rows[keep], t_cols[keep]
    order = np.lexsort((t_cols, t_rows))
    counts = np.bincount(t_rows[order], minlength=m).astype(np.int64)
    return t_rows[order], t_cols[order], keep[order], counts


def transpose(A: ELL, conjugate: bool = False, width=None) -> ELL:
    n, m = A.shape
    _, t_cols, src, counts = _coo_transposed(A.cols, A.row_nnz, n, m)
    vals = np.asarray(A.vals).reshape(-1)[src]
    vals = np.conj(vals) if conjugate else vals
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return ell_from_csr_arrays(indptr, t_cols, vals, (m, n), width=width)


def btranspose(A: BELL, conjugate: bool = False, width=None) -> BELL:
    """The transpose of a block matrix: block pattern transposed and every
    block transposed (conjugated with ``conjugate``)."""
    nb, mb = A.n_block_rows, A.n_block_cols
    br, bc = A.blocksize
    t_rows, t_cols, src, counts = _coo_transposed(A.cols, A.row_nnz, nb, mb)
    blocks = np.swapaxes(np.asarray(A.vals), -1, -2).reshape(-1, bc, br)[src]
    blocks = np.conj(blocks) if conjugate else blocks
    if width is None:
        width = max(int(counts.max()) if mb else 0, 1)
    cols = np.zeros((mb, width), np.int32)
    vals = np.zeros((mb, width, bc, br), blocks.dtype)
    if len(t_rows):
        indptr = np.concatenate([[0], np.cumsum(counts)])
        offs = np.arange(len(t_rows)) - np.repeat(indptr[:-1], counts)
        cols[t_rows, offs] = t_cols
        vals[t_rows, offs] = blocks
    return BELL(cols, vals, counts.astype(np.int32), (A.shape[1], A.shape[0]),
                (bc, br))
