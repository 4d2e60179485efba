"""Tentative prolongator by per-aggregate QR (counterpart of the host
path of ``pyamg_tpu/aggregation/tentative.py:fit_candidates``).

Modified Gram-Schmidt over each aggregate's block of candidates, batched
over aggregates with numpy; a column whose post-orthogonalization norm
falls below ``tol`` times its pre-norm is dropped (a zero column of T and
of R).  With K1 unknowns a node and K2 candidates T is a BELL of (K1, K2)
blocks, one per node; with one of each, an ELL.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL


def _membership(AggOp: ELL):
    """(members, labels): members (nagg, m_max) int32 with -1 padding."""
    n, nagg = AggOp.shape
    has = np.asarray(AggOp.row_nnz) > 0
    labels = np.where(has, np.asarray(AggOp.cols[:, 0]), -1)
    order = np.argsort(labels, kind="stable")
    order = order[labels[order] >= 0]
    sorted_labels = labels[order]
    counts = np.bincount(sorted_labels, minlength=nagg)
    m_max = int(counts.max()) if nagg else 1
    members = np.full((nagg, max(m_max, 1)), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    offs = np.arange(len(order)) - starts[sorted_labels]
    members[sorted_labels, offs] = order
    return members, labels


def fit_candidates(AggOp: ELL, B, tol=1e-10):
    """(T, Bc): the tentative prolongator of the (n nodes x nagg) aggregation
    ``AggOp`` and candidates B (n * K1 rows, K2 columns), and the coarse
    candidates Bc = R of shape (nagg * K2, K2).  T is an (n x nagg) ELL for
    K1 = K2 = 1, else an (n K1 x nagg K2) BELL of (K1, K2) blocks."""
    B = np.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    n, nagg = AggOp.shape
    K2 = B.shape[1]
    K1 = B.shape[0] // n
    if K1 * n != B.shape[0]:
        raise ValueError("B row count must be a multiple of n")
    dtype = B.dtype

    members, labels = _membership(AggOp)
    m_max = members.shape[1]
    pad = members < 0
    idx = np.where(pad, 0, members)
    blk = B.reshape(n, K1, K2)[idx]                 # (nagg, m_max, K1, K2)
    blk[pad] = 0
    work = blk.reshape(nagg, m_max * K1, K2).astype(dtype, copy=True)

    Q = np.zeros_like(work)
    R = np.zeros((nagg, K2, K2), dtype)
    for j in range(K2):
        col = work[:, :, j].copy()
        pre = np.sqrt(np.real(np.sum(np.conj(col) * col, axis=1)))
        for i in range(j):
            rij = np.sum(np.conj(Q[:, :, i]) * col, axis=1)
            col -= rij[:, None] * Q[:, :, i]
            R[:, i, j] = rij.astype(dtype)
        nrm = np.sqrt(np.real(np.sum(np.conj(col) * col, axis=1)))
        keep = nrm > tol * pre
        safe = np.where(nrm == 0, 1, nrm)
        Q[:, :, j] = np.where(keep[:, None], col / safe[:, None], 0)
        R[:, j, j] = np.where(keep, nrm, 0).astype(dtype)

    Tblocks = np.zeros((n, K1, K2), dtype)
    Tblocks[idx[~pad]] = Q.reshape(nagg, m_max, K1, K2)[~pad]
    has = labels >= 0
    cols = np.where(has, labels, 0).astype(np.int32)[:, None]
    Bc = R.reshape(nagg * K2, K2)
    if K1 == 1 and K2 == 1:
        vals = np.where(has, Tblocks[:, 0, 0], 0)[:, None]
        return ELL(cols, vals, has.astype(np.int32), (n, nagg)), Bc
    vals = np.where(has[:, None, None], Tblocks, 0)[:, None, :, :]
    return BELL(cols, vals, has.astype(np.int32), (n * K1, nagg * K2),
                (K1, K2)), Bc
