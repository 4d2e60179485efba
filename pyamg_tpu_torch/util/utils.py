"""Option and operator helpers (counterpart of ``levelize`` and
``filter_matrix_rows`` of ``pyamg_tpu/util/utils.py``) and the setup
clock of the solver constructors."""

from __future__ import annotations

import time

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL


def levelize(spec, max_levels):
    """Per-level option list: a single spec broadcasts; a list extends
    with its last element (reference ``levelize_strength_or_aggregation``
    and ``levelize_smooth_or_improve_candidates``)."""
    if isinstance(spec, list) or (
            isinstance(spec, tuple) and len(spec) and
            (isinstance(spec[0], (tuple, list)) or spec[0] is None or
             (isinstance(spec[0], str) and not (
                 len(spec) == 2 and isinstance(spec[1], dict))))):
        items = list(spec)
    else:
        items = [spec]
    k = max(max_levels - 1, 1)
    items = items + [items[-1]] * k
    return items[:k]


def filter_matrix_rows(A: ELL, theta, diagonal=False, lump=False):
    """Row-wise drop tolerance (reference ``utils.py:2012``,
    ``amg_core/linalg.h:1076``), in A's dtype.

    ``diagonal=True``: drop off-diagonal ``|A_ij| < theta * |A_ii|`` (the
    diagonal itself is kept).  ``diagonal=False``: drop entries below
    ``theta * max_k |A_ik|``.  ``lump`` adds each row's dropped mass to its
    diagonal (which is then always kept), preserving row sums."""
    from pyamg_tpu_torch.ops.rowops import ell_dedup
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    isdiag = cols == np.arange(A.shape[0], dtype=np.int32)[:, None]
    valid = A.valid_mask()
    absv = np.where(valid, np.abs(vals), 0)
    if diagonal:
        dmag = np.max(np.where(isdiag, absv, 0), axis=1, keepdims=True)
        keep = valid & (isdiag | (absv >= theta * dmag))
    else:
        mx = np.max(absv, axis=1, keepdims=True)
        keep = valid & (absv >= theta * mx)
        if lump:
            # the lumped mass lands on the diagonal slot, which must
            # survive the filter for the row sum to be kept
            keep = keep | (valid & isdiag)
    vals_kept = np.where(keep, vals, 0)
    if lump:
        dropped = np.where(valid & ~keep, vals, 0)
        # left to right along the row, as the reference's reduction adds
        mass = np.zeros_like(dropped[:, 0])
        for j in range(dropped.shape[1]):
            mass = mass + dropped[:, j]
        vals_kept = vals_kept + np.where(isdiag, mass[:, None], 0)
    return ell_dedup(cols, vals_kept, keep, A.shape)


class SetupClock:
    """Wall time of the setup phases of one level, summed by key:
    ``mark(key)`` charges the time since the last mark to ``key``."""

    def __init__(self):
        self.times = {}
        self._t0 = time.perf_counter()

    def mark(self, key):
        now = time.perf_counter()
        self.times[key] = self.times.get(key, 0.0) + (now - self._t0)
        self._t0 = now
