"""Poisson and gauge-Laplacian model problems (counterpart of
``pyamg_tpu/gallery/laplacian.py``)."""

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


def gauge_laplacian(npts, spacing=1.0, beta=0.1, seed=None):
    """2D QCD gauge Laplacian (complex Hermitian for beta > 0), a host
    ELL: the 5-point Laplacian with its couplings replaced by random U(1)
    phases drawn by ``default_rng(seed)``, periodic wrap links, and
    diagonal 4/h^2 (reference ``laplacian.py:82``), built in COO on the
    host as the JAX package builds it.
    """
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import from_scipy

    rng = np.random.default_rng(seed)
    N = int(npts)
    n = N * N
    alpha_x = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(n)
    alpha_y = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(n)

    rows, cols, data = [], [], []

    def link(r, c, alpha):
        # directed link r -> c with phase exp(+a) one way, exp(-a) back
        a = alpha[min(r, c)]
        s = -1.0 if r > c else 1.0
        rows.append(r)
        cols.append(c)
        data.append(-1.0 * np.exp(s * a))

    for i in range(n):
        # x-direction neighbors (stride 1 within a row of the grid)
        if (i + 1) % N != 0:
            link(i, i + 1, alpha_x)
            link(i + 1, i, alpha_x)
        # y-direction neighbors (stride N)
        if i + N < n:
            link(i, i + N, alpha_y)
            link(i + N, i, alpha_y)
    # periodic wrap links
    alpha_xp = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(n)
    alpha_yp = 1.0j * 2.0 * np.pi * beta * rng.standard_normal(n)
    for i in range(N):                    # top row <-> bottom row (y wrap)
        r, c = i, i + n - N
        rows += [r, c]
        cols += [c, r]
        a = alpha_yp[min(r, c)]
        data += [-np.exp(1.0 * a), -np.exp(-1.0 * a)]
    for i in range(0, n, N):              # left col <-> right col (x wrap)
        r, c = i, i + N - 1
        rows += [r, c]
        cols += [c, r]
        a = alpha_xp[min(r, c)]
        data += [-np.exp(1.0 * a), -np.exp(-1.0 * a)]

    for i in range(n):
        rows.append(i)
        cols.append(i)
        data.append(4.0 + 0.0j)

    A = sp.coo_matrix((np.asarray(data), (np.asarray(rows), np.asarray(cols))),
                      shape=(n, n)).tocsr()
    A = A / spacing**2
    return from_scipy(A)
