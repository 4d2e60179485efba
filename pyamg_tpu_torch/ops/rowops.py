"""Row-wise operations on host ELL matrices (setup phase).

Counterpart of the host twins in ``pyamg_tpu/ops/rowops.py``:
``dedup_rows`` (the host form, and of tensors the device form that the
distributed setup and the device SpGEMM run) and ``compact_width``;
``ell_dedup`` sorts each row's candidate (col, val) pairs by column, sums
duplicate columns and left-compacts (stored entries that sum to zero stay
stored, as in the reference, because stored-entry counts feed the operator
complexity); ``row_lookup`` gathers A's entries at given columns row by
row; ``drop_explicit_zeros`` filters stored entries by magnitude.
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


def dedup_rows(cols, vals, valid, n_cols: int):
    """Coalesce each row's candidate entries: ``dedup_rows_host`` of host
    arrays; of tensors, the JAX package's device form
    (``pyamg_tpu/ops/rowops.py:78``), over the last axis of ``cols`` of
    any leading shape: sort by column (invalid entries carry the
    ``n_cols`` sentinel and a zero value), take the running sum, move the
    ends of the equal-column runs to the front with a stable sort, and
    difference them.  ``vals`` may hold a block a slot (trailing axes
    past ``cols``'s shape, the JAX package's ``_dedup_blocks``): the
    blocks ride along by the sorts' permutations.  Its values are
    differences of running sums: they round otherwise than the host
    twin's direct sums.  The first sort is stable here, where the JAX
    package's need not be, so duplicates may meet in another order and
    round in their last bit."""
    import torch
    if not any(isinstance(v, torch.Tensor) for v in (cols, vals, valid)):
        return dedup_rows_host(cols, vals, valid, n_cols)
    W, axis = cols.shape[-1], cols.ndim - 1
    block = (1,) * (vals.ndim - cols.ndim)

    def per_slot(t, like):
        """``t`` (``cols``'s shape) broadcast over the blocks of ``like``."""
        return t.reshape(t.shape + block).expand(t.shape + like.shape[
            cols.ndim:])

    c = torch.where(valid, cols.to(torch.int64), int(n_cols))
    v = torch.where(per_slot(valid, vals), vals, 0)
    live = c < n_cols
    if W == 1:
        return (torch.where(live, c, 0).to(cols.dtype), v,
                live[..., 0].to(torch.int32))
    c, order = torch.sort(c, dim=-1, stable=True)
    v = torch.gather(v, axis, per_slot(order, v))
    neq = c[..., 1:] != c[..., :-1]
    ones = torch.ones(c.shape[:-1] + (1,), dtype=torch.bool, device=c.device)
    head = torch.cat([ones, neq], dim=-1) & (c < n_cols)
    row_nnz = torch.sum(head, dim=-1, dtype=torch.int32)
    s = torch.cumsum(v, dim=axis)
    # the ends of the runs, in column order, first
    islast = torch.cat([neq, ones], dim=-1)
    order = torch.sort((~islast).to(torch.int8), dim=-1, stable=True).indices
    c2 = torch.gather(c, -1, order)
    s2 = torch.gather(s, axis, per_slot(order, s))
    prev = torch.cat([torch.zeros_like(s2.narrow(axis, 0, 1)),
                      s2.narrow(axis, 0, W - 1)], dim=axis)
    keep = torch.arange(W, device=c.device) < row_nnz[..., None]
    return (torch.where(keep, c2, 0).to(cols.dtype),
            torch.where(per_slot(keep, s2), s2 - prev, 0), row_nnz)


def compact_width(cols, vals, row_nnz, shape, width=None,
                  min_width=1) -> ELL:
    """A host ELL of coalesced rows, its width cut to ``width`` (default
    the largest row, at least ``min_width``)."""
    if width is None:
        # a tensor's largest row is one host read
        rn = row_nnz.cpu().numpy() if hasattr(row_nnz, "cpu") else \
            np.asarray(row_nnz)
        width = max(int(np.max(rn)) if rn.shape[0] else 0, min_width)
    width = min(width, cols.shape[1]) if cols.shape[1] > 0 else min_width
    return ELL(cols[:, :width], vals[:, :width], row_nnz,
               (int(shape[0]), int(shape[1])))


def ell_dedup(cols, vals, valid, shape, width=None, min_width=1) -> ELL:
    """Coalesced host ELL of the candidate entries, width shrunk to the
    largest row."""
    c, v, rn = dedup_rows_host(cols, vals, valid, shape[1])
    return compact_width(c, v, rn, shape, width=width, min_width=min_width)


def row_lookup(A: ELL, qcols, qvalid=None):
    """Per-row membership lookup: ``out[i, k] = A[i, qcols[i, k]]`` (0 where
    absent or where ``qvalid`` is False).  A's rows are column-sorted with a
    zero-padding tail; one flat searchsorted over the rows laid end to end
    with per-row offsets."""
    n, W = A.cols.shape
    sent = np.int64(A.shape[1]) + 1
    k = np.arange(W, dtype=np.int64)[None, :]
    acols = np.where(k < np.asarray(A.row_nnz)[:, None],
                     np.asarray(A.cols, np.int64), sent)
    roff = (sent + 1) * np.arange(n, dtype=np.int64)[:, None]
    flat = (acols + roff).ravel()          # globally sorted
    q = np.asarray(qcols, np.int64) + roff[:, :1]
    idx = np.clip(np.searchsorted(flat, q.ravel()).reshape(q.shape), 0,
                  n * W - 1)
    hit = flat[idx] == q
    out = np.asarray(A.vals).reshape(-1)[idx]
    if qvalid is not None:
        hit = hit & np.asarray(qvalid)
    return np.where(hit, out, 0)


def drop_explicit_zeros(A: ELL, tol: float = 0.0) -> ELL:
    """A without its stored entries of ``|val| <= tol`` (the diagonal is not
    treated apart)."""
    keep = (np.abs(np.asarray(A.vals)) > tol) & A.valid_mask()
    return ell_dedup(A.cols, A.vals, keep, A.shape)
