"""Sparse x sparse product of host ELL matrices (setup phase; the host
path of ``pyamg_tpu/ops/spgemm.py:spgemm``): scipy's SMMP SpGEMM."""

from __future__ import annotations

from pyamg_tpu_torch.sparse.matrix import ELL, ell_from_csr_arrays, to_scipy


def spgemm(A: ELL, B: ELL, width=None) -> ELL:
    """C = A @ B."""
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    C = (to_scipy(A) @ to_scipy(B)).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return ell_from_csr_arrays(C.indptr, C.indices, C.data,
                               (A.shape[0], B.shape[1]), width=width)
