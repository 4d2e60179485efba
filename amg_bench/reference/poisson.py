"""The operators of the benchmark's configurations, built from the grid
alone: 2-D Poisson with the 5-point stencil and Dirichlet boundaries,
unknown (i, j) at row i * n + j, as PyAMG's ``gallery.poisson((n, n))``
numbers them.  Plain SciPy; imports nothing of the program."""

import numpy as np
import scipy.sparse as sp


def poisson2d(n, dtype=np.float64):
    """The n^2 x n^2 5-point Laplacian (4 on the diagonal, -1 to each grid
    neighbour), CSR."""
    T = sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                 [-1, 0, 1], format="csr")
    eye = sp.identity(n, format="csr")
    A = (sp.kron(eye, T) + sp.kron(T, eye)).tocsr()
    A.sort_indices()
    return A.astype(dtype)


def true_relres(A, b, x):
    """||b - A x|| / ||b|| in float64."""
    x = np.asarray(x, np.float64).reshape(-1)
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
