"""Random sparse matrices (counterpart of
``pyamg_tpu/gallery/random_sparse.py``)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from pyamg_tpu_torch.sparse.matrix import from_scipy


def sprand(m, n, density, format=None, seed=None):
    """Random sparse matrix with standard-normal entries (reference
    ``random_sparse.py:20``), drawn by ``default_rng(seed)``.  Returns a
    host ELL, or scipy sparse in ``format``."""
    m, n = int(m), int(n)
    rng = np.random.default_rng(seed)
    nnz = max(min(int(m * n * density), m * n), 0)
    row = rng.integers(low=0, high=m, size=nnz)
    col = rng.integers(low=0, high=n, size=nnz)
    data = rng.standard_normal(nnz)
    A = sp.coo_matrix((data, (row, col)), shape=(m, n)).tocsr()
    if format is not None:
        return A.asformat(format)
    return from_scipy(A)
