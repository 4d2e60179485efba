"""Row-wise coalescing of host ELL candidate entries (setup phase).

Counterpart of the host twin in ``pyamg_tpu/ops/rowops.py``: sort each
row's candidate (col, val) pairs by column, sum duplicate columns and
left-compact.  Stored entries that sum to zero stay stored, as in the
reference, because stored-entry counts feed the operator complexity.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL


def dedup_rows_host(cols, vals, valid, n_cols: int):
    """(out_cols, out_vals, row_nnz): valid entries per row, sorted by
    column with duplicates summed, left-compacted (zero tail)."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    valid = np.asarray(valid)
    n, W = cols.shape
    sent = np.int32(min(n_cols, 2 ** 31 - 1))
    c = np.where(valid, cols.astype(np.int32, copy=False), sent)
    v = np.where(valid, vals, 0)
    # already sorted with no duplicates: the input is its own answer
    if W > 1 and not ((c[:, 1:] <= c[:, :-1]) & (c[:, 1:] < sent)).any():
        live = c < sent
        row_nnz = live.sum(axis=1, dtype=np.int32)
        return (np.where(live, c, 0).astype(np.int32, copy=False),
                np.where(live, v, 0), row_nnz)
    order = np.argsort(c, axis=1, kind="stable")
    c = np.take_along_axis(c, order, axis=1)
    v = np.take_along_axis(v, order, axis=1)
    head = np.concatenate(
        [np.ones((n, 1), bool), c[:, 1:] != c[:, :-1]], axis=1)
    head = head & (c < sent)
    row_nnz = head.sum(axis=1, dtype=np.int32)
    if W == 1 or not ((c[:, 1:] == c[:, :-1]) & (c[:, 1:] < sent)).any():
        keepc = np.where(head, c, 0).astype(np.int32, copy=False)
        return keepc, np.where(head, v, 0), row_nnz
    pos = np.maximum(np.cumsum(head, axis=1) - 1, 0)
    rows = np.broadcast_to(np.arange(n)[:, None], (n, W))
    out_vals = np.zeros_like(v)
    np.add.at(out_vals, (rows, pos), v)
    out_cols = np.zeros((n, W), np.int32)
    np.maximum.at(out_cols, (rows, pos),
                  np.where(head, c, 0).astype(np.int32, copy=False))
    tail = np.arange(W)[None, :] >= row_nnz[:, None]
    out_vals[tail] = 0
    out_cols[tail] = 0
    return out_cols, out_vals, row_nnz


def ell_dedup(cols, vals, valid, shape, width=None, min_width=1) -> ELL:
    """Coalesced host ELL of the candidate entries, width shrunk to the
    largest row."""
    c, v, rn = dedup_rows_host(cols, vals, valid, shape[1])
    if width is None:
        width = max(int(rn.max()) if rn.shape[0] else 0, min_width)
    width = min(width, c.shape[1]) if c.shape[1] > 0 else min_width
    return ELL(c[:, :width], v[:, :width], rn,
               (int(shape[0]), int(shape[1])))
