"""Upwind finite differences of 2-D advection (counterpart of
``pyamg_tpu/gallery/advection.py``; reference
``pyamg/gallery/advection.py:7``)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.gallery.stencil import stencil_grid
from pyamg_tpu_torch.sparse.matrix import from_scipy


def advection_2d(grid, theta=np.pi / 4.0, l_bdry=1.0, b_bdry=1.0,
                 format=None):
    """Matrix and right-hand side of the upwind discretization of
    ``(cos t, sin t) . grad(u) = 0`` with inflow boundaries on the left and
    bottom, whose values move to the right-hand side: ``(A, rhs)``, A a
    host ELL (or scipy in ``format``)."""
    grid = tuple(grid)
    if len(grid) != 2:
        raise ValueError("grid must be a length 2 tuple")
    if theta <= 0 or theta >= np.pi / 2:
        raise ValueError("theta must be in (0, pi/2)")
    w1, w2 = np.cos(theta), np.sin(theta)
    st = np.array([[0, 0, 0], [-w1, w1 + w2, 0], [0, -w2, 0]])
    A = stencil_grid(st, grid, format="csr")

    ny, nx = grid
    l_bdofs = np.arange(ny) * nx
    b_bdofs = nx * (ny - 1) + np.arange(nx)
    all_bdofs = np.unique(np.concatenate((l_bdofs, b_bdofs)))
    int_dofs = np.setdiff1d(np.arange(A.shape[0]), all_bdofs)
    if np.isscalar(l_bdry):
        l_bdry = np.full(ny, l_bdry)
    elif np.asarray(l_bdry).shape[0] != ny:
        raise ValueError("left boundary data does not match boundary size")
    if np.isscalar(b_bdry):
        b_bdry = np.full(nx, b_bdry)
    elif np.asarray(b_bdry).shape[0] != nx:
        raise ValueError("bottom boundary data does not match boundary size")

    bvals = np.zeros(A.shape[0])
    bvals[l_bdofs] = np.asarray(l_bdry).ravel()
    bvals[b_bdofs] = np.asarray(b_bdry).ravel()
    rhs = -(A[int_dofs, :][:, all_bdofs] @ bvals[all_bdofs])
    A = A[int_dofs, :][:, int_dofs].tocsr()
    if format is not None:
        return A.asformat(format), rhs
    return from_scipy(A), rhs
