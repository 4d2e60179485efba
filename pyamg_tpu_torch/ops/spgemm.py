"""Sparse x sparse products of host matrices (setup phase; the host paths
of ``spgemm``, ``masked_spgemm`` and ``spgemm_bell`` in
``pyamg_tpu/ops/spgemm.py``): scipy's SMMP SpGEMM."""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import (BELL, ELL, bell_from_scipy,
                                           ell_from_csr_arrays, to_scipy)


def _csr_product(A, B):
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    C = (to_scipy(A) @ to_scipy(B)).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def spgemm(A: ELL, B: ELL, width=None) -> ELL:
    """C = A @ B."""
    C = _csr_product(A, B)
    return ell_from_csr_arrays(C.indptr, C.indices, C.data,
                               (A.shape[0], B.shape[1]), width=width)


def masked_spgemm(A: ELL, B: ELL, pattern_cols, pattern_valid):
    """Values of (A @ B) at the slots of a pattern, ``(n, W)`` like
    ``pattern_cols`` (column-sorted rows, the ELL invariant): entries of
    the product outside the pattern are dropped, slots the product does
    not reach (or not ``pattern_valid``) are 0."""
    C = _csr_product(A, B)
    m = C.shape[1]
    rows = np.repeat(np.arange(C.shape[0]), np.diff(C.indptr))
    # float64 keys are exact while row * m + col < 2^53
    kdt = np.float64 if C.shape[0] * m < 2 ** 53 else np.int64
    ckey = rows.astype(kdt) * m + C.indices
    pc = np.asarray(pattern_cols)
    qkey = np.arange(pc.shape[0], dtype=kdt)[:, None] * m + pc
    if not len(ckey):
        return np.zeros(pc.shape, C.data.dtype)
    idx = np.minimum(np.searchsorted(ckey, qkey), len(ckey) - 1)
    hit = (ckey[idx] == qkey) & np.asarray(pattern_valid)
    return np.where(hit, C.data[idx], 0).astype(C.data.dtype)


def spgemm_bell(A: BELL, B: BELL, width=None) -> BELL:
    """Block product C = A @ B (A's block columns as wide as B's block
    rows); C has blocks of (A's rows, B's columns)."""
    if A.blocksize[1] != B.blocksize[0]:
        raise ValueError(f"blocksizes {A.blocksize} and {B.blocksize} do "
                         f"not conform")
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")
    C = (to_scipy(A) @ to_scipy(B)).tobsr((A.blocksize[0], B.blocksize[1]))
    C.sort_indices()
    return bell_from_scipy(C, width=width)
