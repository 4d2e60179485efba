"""Strength of connection (counterpart of ``pyamg_tpu/strength.py``;
setup phase, numpy).

Returned S has each row scaled so its largest entry is 1, diagonal always
kept; S[i, j] != 0 means i is strongly influenced by j.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL
from pyamg_tpu_torch.ops.rowops import ell_dedup


def _scale_rows_by_largest_entry(vals, valid):
    mx = np.max(np.where(valid, np.abs(vals), 0), axis=1, keepdims=True)
    return np.where(mx > 0, vals / np.where(mx == 0, 1, mx), vals)


def symmetric_strength_of_connection(A: ELL, theta=0):
    """|A_ij| >= theta*sqrt(|A_ii A_jj|); diagonal kept (reference
    ``strength.py:248`` / ``smoothed_aggregation.h:56``)."""
    if theta < 0:
        raise ValueError("expected a positive theta")
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    valid = A.valid_mask()
    isdiag = cols == np.arange(n, dtype=np.int32)[:, None]
    dn = np.abs(np.sum(np.where(isdiag & valid, vals, 0), axis=1))
    thresh = (theta * theta) * dn[:, None] * dn[cols]
    keep = valid & ((np.abs(vals) ** 2 >= thresh) | isdiag)
    svals = _scale_rows_by_largest_entry(np.abs(vals), keep)
    return ell_dedup(cols, np.where(keep, svals, 0), keep, A.shape)


def classical_strength_of_connection(A: ELL, theta=0.1, block=True,
                                     norm="abs"):
    """|A_ij| >= theta * max_k!=i |A_ik| (``'abs'``, ``'fro'``) or
    -A_ij >= theta * max_k!=i (-A_ik) (``'min'``), compared in A's dtype;
    diagonal always kept (reference ``strength.py:114`` /
    ``ruge_stuben.h:64``).  ``block`` is the reference's option for BSR
    input, which is not ported."""
    if not isinstance(A, ELL):
        raise NotImplementedError("classical strength of a block (BELL) "
                                  "operator is not ported yet")
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    valid = A.valid_mask()
    offd = valid & (cols != np.arange(n, dtype=np.int32)[:, None])
    if norm in ("abs", "fro"):
        mag = np.abs(vals)
        mx = np.max(np.where(offd, mag, 0), axis=1, keepdims=True)
        keep = offd & (mag >= theta * mx)
    elif norm == "min":
        neg = -np.real(vals)
        mx = np.max(np.where(offd, neg, -np.inf), axis=1, keepdims=True)
        keep = offd & (neg >= theta * mx) & (mx > 0)
    else:
        raise ValueError("unrecognized norm")
    keep = keep | (valid & ~offd)          # always keep the diagonal
    svals = _scale_rows_by_largest_entry(np.abs(vals), keep)
    return ell_dedup(cols, np.where(keep, svals, 0), keep, A.shape)


def strength_measure(A: ELL, spec):
    """Dispatch PyAMG's ``(name, opts)`` strength convention: ``None``
    (the |A| pattern), ``'symmetric'`` or ``'classical'``."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = (None, {}) if spec is None else unpack_arg(spec)
    if name is None:
        return ELL(A.cols, np.abs(A.vals), A.row_nnz, A.shape)
    if name == "symmetric":
        return symmetric_strength_of_connection(A, **opts)
    if name == "classical":
        return classical_strength_of_connection(A, **opts)
    raise NotImplementedError(f"strength {name!r} is not ported yet (only "
                              f"'symmetric', 'classical' and None)")
