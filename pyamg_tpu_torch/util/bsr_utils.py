"""Row get/set helpers for host block (BELL) matrices (counterpart of
``pyamg_tpu/util/bsr_utils.py``).  The containers are immutable, so the
setters return a new ``BELL``."""

from __future__ import annotations

import dataclasses

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL


def bsr_getrow(A: BELL, i: int):
    """``(values (k, 1), scalar columns (k,))`` of the non-zeros of scalar
    row ``i``, in column order; zeros stored inside blocks are left out."""
    br, bc = A.blocksize
    bi, lr = divmod(int(i), br)
    vals = np.asarray(A.vals[bi, :, lr, :])        # (W, bc)
    cols = np.asarray(A.cols[bi])
    valid = A.valid_mask()[bi]
    out_v, out_c = [], []
    for w in np.flatnonzero(valid):
        nz = np.nonzero(vals[w])[0]
        out_v.extend(vals[w][nz].tolist())
        out_c.extend((cols[w] * bc + nz).tolist())
    order = np.argsort(out_c, kind="stable")
    return (np.asarray(out_v)[order].reshape(-1, 1),
            np.asarray(out_c, dtype=np.int32)[order])


def _set_row(A: BELL, i: int, new):
    """A with the stored entries of scalar row ``i`` set from ``new``
    ((W, bc), the block row's slots)."""
    bi, lr = divmod(int(i), A.blocksize[0])
    vals = np.array(A.vals)
    valid = A.valid_mask()[bi][:, None]
    vals[bi, :, lr, :] = np.where(valid, new, vals[bi, :, lr, :])
    return dataclasses.replace(A, vals=vals)


def bsr_row_setscalar(A: BELL, i: int, x) -> BELL:
    """Every stored entry of scalar row ``i`` set to the scalar ``x``
    (within the stored block pattern)."""
    return _set_row(A, i, x)


def bsr_row_setvector(A: BELL, i: int, x) -> BELL:
    """Scalar row ``i`` overwritten by the dense vector ``x`` on the stored
    block pattern; entries of ``x`` outside it are dropped."""
    bc = A.blocksize[1]
    bi = int(i) // A.blocksize[0]
    x = np.asarray(x, A.vals.dtype).reshape(-1)
    idx = np.asarray(A.cols[bi])[:, None] * bc + np.arange(bc)[None, :]
    return _set_row(A, i, x[np.clip(idx, 0, x.shape[0] - 1)])
