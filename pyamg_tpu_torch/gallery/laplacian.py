"""Poisson model problem (counterpart of ``pyamg_tpu/gallery/laplacian.py:poisson``)."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.gallery.stencil import stencil_grid


def poisson(grid, dtype=float, format=None, type="FD"):
    """N-dimensional Poisson on a regular grid with Dirichlet boundaries.

    FD: central differences (2N on the diagonal, -1 to axis neighbours).
    FE: Q1 finite elements (full (3,)*N stencil of -1, 3^N - 1 centre).

    Examples
    --------
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> poisson((4, 4)).shape
    (16, 16)
    """
    grid = tuple(grid)
    N = len(grid)
    if N < 1 or min(grid) < 1:
        raise ValueError(f"invalid grid shape: {grid}")
    if type == "FD":
        stencil = np.zeros((3,) * N, dtype=dtype)
        for i in range(N):
            stencil[(1,) * i + (0,) + (1,) * (N - i - 1)] = -1
            stencil[(1,) * i + (2,) + (1,) * (N - i - 1)] = -1
        stencil[(1,) * N] = 2 * N
    elif type == "FE":
        stencil = -np.ones((3,) * N, dtype=dtype)
        stencil[(1,) * N] = 3**N - 1
    else:
        raise ValueError("type must be 'FD' or 'FE'")
    return stencil_grid(stencil, grid, format=format)
