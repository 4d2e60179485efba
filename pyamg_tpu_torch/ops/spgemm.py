"""Sparse x sparse products (counterpart of ``pyamg_tpu/ops/spgemm.py``).

Host arrays take scipy's SMMP SpGEMM, as the setup phase does.  Tensors
take the JAX package's device form, as torch ops on their device (a host
operand is moved there): for ``C = A @ B`` with pad widths WA and WB,
row i of C lies among the WA * WB candidates

    cand_cols[i] = B.cols[A.cols[i, :], :]
    cand_vals[i] = A.vals[i, :, None] * B.vals[A.cols[i, :], :]

(``_expand``), which ``rowops.dedup_rows`` sorts and coalesces row by
row.  The output width depends on the data: without an explicit
``width`` it is one host read.  ``masked_spgemm`` looks each slot of a
pattern up among the coalesced candidates; ``spgemm_bell`` forms block
candidates and coalesces blocks (``_dedup_blocks``).
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor
from pyamg_tpu_torch.ops.rowops import compact_width, dedup_rows
from pyamg_tpu_torch.sparse.matrix import (BELL, ELL, bell_from_scipy,
                                           ell_from_csr_arrays, to_scipy)

# the device dedup_rows coalesces blocks too (trailing axes of vals)
_dedup_blocks = dedup_rows


def _device_of(*arrays):
    """The device of the first tensor among ``arrays``; None when all are
    host arrays."""
    return next((a.device for a in arrays if isinstance(a, torch.Tensor)),
                None)


def _check_inner(A, B):
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"inner dimensions differ: {A.shape} @ {B.shape}")


def _csr_product(A, B):
    C = (to_scipy(A) @ to_scipy(B)).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def _gather_rows(A, B):
    """B's columns, stored-slot mask and values gathered at each of A's
    slots, ``(n, WA, WB)`` and ``(n, WA, WB, ...)``: one 2-D gather
    (``B.cols[A.cols]``), in the order of the JAX package's WA row gathers
    concatenated (``pyamg_tpu/ops/spgemm.py:52-61``)."""
    idx = A.cols
    a_ok = torch.arange(A.width, device=idx.device) < A.row_nnz[:, None]
    b_ok = torch.arange(B.width, device=idx.device) < \
        B.row_nnz[idx][..., None]
    return B.cols[idx], a_ok[..., None] & b_ok, B.vals[idx]


def _expand(A: ELL, B: ELL):
    """Candidate ``(cols, vals, valid)`` of ``A @ B``, each ``(n, WA *
    WB)``, slot-major: candidate ``j * WB + k`` is B's slot k of the row
    at A's slot j, valid where both slots are stored."""
    n = A.shape[0]
    cols, ok, bv = _gather_rows(A, B)
    vals = A.vals[:, :, None] * bv
    return cols.reshape(n, -1), vals.reshape(n, -1), ok.reshape(n, -1)


def spgemm(A: ELL, B: ELL, width=None) -> ELL:
    """C = A @ B: of host arrays by scipy, of tensors by the device form
    on their device (``width`` None: the widest row, one host read)."""
    _check_inner(A, B)
    shape = (A.shape[0], B.shape[1])
    device = _device_of(A.cols, A.vals, B.cols, B.vals)
    if device is None:
        C = _csr_product(A, B)
        return ell_from_csr_arrays(C.indptr, C.indices, C.data, shape,
                                   width=width)
    c, v, rn = dedup_rows(*_expand(A.to(device), B.to(device)), B.shape[1])
    return compact_width(c, v, rn, shape, width=width)


def masked_spgemm(A: ELL, B: ELL, pattern_cols, pattern_valid):
    """Values of (A @ B) at the slots of a pattern, ``(n, W)`` like
    ``pattern_cols`` (column-sorted rows, the ELL invariant): entries of
    the product outside the pattern are dropped, slots the product does
    not reach (or not ``pattern_valid``) are 0.  Of tensors (any operand)
    a tensor on their device, with no host read."""
    _check_inner(A, B)
    device = _device_of(A.cols, A.vals, B.cols, B.vals, pattern_cols,
                        pattern_valid)
    if device is None:
        return _masked_host(A, B, pattern_cols, pattern_valid)
    pc = as_tensor(pattern_cols, device, torch.int64)
    pv = as_tensor(pattern_valid, device, torch.bool)
    c, v, rn = dedup_rows(*_expand(A.to(device), B.to(device)), B.shape[1])
    # the coalesced rows end in a zero tail: the sentinel n_cols there
    # keeps each row sorted for the search
    W = c.shape[1]
    cs = torch.where(torch.arange(W, device=device) < rn[:, None],
                     c.to(torch.int64), B.shape[1])
    idx = torch.searchsorted(cs, pc).clamp_(0, W - 1)
    hit = torch.gather(cs, 1, idx) == pc
    return torch.where(hit & pv, torch.gather(v, 1, idx), 0)


def _masked_host(A, B, pattern_cols, pattern_valid):
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
    rows); C has blocks of (A's rows, B's columns).  Of tensors, the
    device form: candidate blocks ``A_ij @ B_jk`` by one einsum, coalesced
    by ``_dedup_blocks`` (``width`` None: one host read)."""
    if A.blocksize[1] != B.blocksize[0]:
        raise ValueError(f"blocksizes {A.blocksize} and {B.blocksize} do "
                         f"not conform")
    _check_inner(A, B)
    blocksize = (A.blocksize[0], B.blocksize[1])
    device = _device_of(A.cols, A.vals, B.cols, B.vals)
    if device is None:
        C = (to_scipy(A) @ to_scipy(B)).tobsr(blocksize)
        C.sort_indices()
        return bell_from_scipy(C, width=width)
    A, B = A.to(device), B.to(device)
    nb = A.n_block_rows
    cols, ok, bv = _gather_rows(A, B)
    vals = torch.einsum("nwij,nwvjk->nwvik", A.vals, bv)
    c, v, rn = _dedup_blocks(cols.reshape(nb, -1),
                             vals.reshape((nb, -1) + blocksize),
                             ok.reshape(nb, -1), B.n_block_cols)
    if width is None:
        width = max(int(rn.max()) if nb else 0, 1)
    width = min(width, c.shape[1]) if c.shape[1] else 1
    return BELL(c[:, :width], v[:, :width], rn, (A.shape[0], B.shape[1]),
                blocksize)
