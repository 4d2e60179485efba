"""Sparse operators from local stencils on regular grids (counterpart of
``pyamg_tpu/gallery/stencil.py``): vertices in C order, zero Dirichlet
boundaries.  Host ELL with ``grid`` metadata (setup phase)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL, to_scipy


def stencil_grid(S, grid, dtype=None, format=None):
    """Operator applying stencil ``S`` at every vertex of ``grid``: a host
    ``ELL`` by default, or the scipy matrix in ``format``."""
    S = np.asarray(S, dtype=dtype)
    grid = tuple(int(g) for g in grid)
    if len(grid) != S.ndim:
        raise ValueError("stencil dimension must equal number of grid dims")
    if min(grid) < 1:
        raise ValueError("grid dimensions must be positive")
    if any(s % 2 == 0 for s in S.shape):
        raise ValueError("all stencil dimensions must be odd")

    n = int(np.prod(grid))
    strides = np.cumprod([1] + list(reversed(grid)))[:-1][::-1]  # C-order
    nz = np.argwhere(S != 0)
    center = np.array([s // 2 for s in S.shape])
    offsets = nz - center                                  # (k, ndim)
    lin_off = offsets @ strides                            # (k,)
    svals = S[tuple(nz.T)]
    order = np.argsort(lin_off, kind="stable")
    offsets, lin_off, svals = offsets[order], lin_off[order], svals[order]
    k = len(lin_off)

    rows32 = np.arange(n, dtype=np.int32)
    ndim = len(grid)
    coords_ax = [(rows32 // np.int32(strides[d])) % np.int32(grid[d])
                 for d in range(ndim)]
    valid = np.empty((n, k), bool)
    for j in range(k):
        vj = np.ones(n, bool)
        for d in range(ndim):
            o = int(offsets[j, d])
            if o > 0:
                vj &= coords_ax[d] < np.int32(grid[d] - o)
            elif o < 0:
                vj &= coords_ax[d] >= np.int32(-o)
        valid[:, j] = vj

    cols = rows32[:, None] + lin_off.astype(np.int32)[None, :]
    vals = np.broadcast_to(svals[None, :], (n, k)).copy()
    # left-compact the boundary rows (stable: column order kept)
    bad = np.flatnonzero(~valid.all(axis=1))
    if bad.size:
        vb = valid[bad]
        idx = np.argsort(~vb, axis=1, kind="stable")
        vmask = np.take_along_axis(vb, idx, axis=1)
        cols[bad] = np.where(
            vmask, np.take_along_axis(cols[bad], idx, axis=1), 0)
        vals[bad] = np.where(
            vmask, np.take_along_axis(vals[bad], idx, axis=1), 0)
    row_nnz = valid.sum(axis=1).astype(np.int32)

    A = ELL(cols, vals, row_nnz, (n, n), grid=grid)
    if format is None:
        return A
    return to_scipy(A).asformat(format)
