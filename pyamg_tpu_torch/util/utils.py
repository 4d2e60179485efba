"""Option and operator helpers (counterpart of ``levelize``,
``filter_matrix_rows``, ``truncate_rows``, ``unamal``, the root-node
scaffolding ``scale_T`` and ``get_Cpt_params``, ``compute_BtBinv``,
``filter_operator`` and ``eliminate_diag_dom_nodes`` of
``pyamg_tpu/util/utils.py``; setup phase, numpy) and the setup clock of
the solver constructors."""

from __future__ import annotations

import time

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL


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


def truncate_rows(A: ELL, nz_per_row):
    """Keep the ``nz_per_row`` largest-magnitude entries of each row (ties
    to the earlier slot; reference ``utils.py:2105``)."""
    from pyamg_tpu_torch.ops.rowops import ell_dedup
    valid = A.valid_mask()
    mag = np.where(valid, np.abs(A.vals), -1.0)
    order = np.argsort(-mag, axis=1, kind="stable")
    rank = np.argsort(order, axis=1, kind="stable")
    keep = valid & (rank < nz_per_row)
    return ell_dedup(A.cols, np.where(keep, A.vals, 0), keep, A.shape)


def unamal(A: ELL, RowsPerBlock: int, ColsPerBlock: int) -> ELL:
    """The node graph A expanded to unknowns: every stored entry becomes a
    ``RowsPerBlock x ColsPerBlock`` block of ones (reference
    ``utils.py:749``)."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
    As = to_scipy(A)
    data = np.ones((As.nnz, RowsPerBlock, ColsPerBlock), dtype=As.dtype)
    B = sp.bsr_matrix((data, As.indices, As.indptr),
                      shape=(As.shape[0] * RowsPerBlock,
                             As.shape[1] * ColsPerBlock))
    return from_scipy(B.tocsr())


def eliminate_diag_dom_nodes(A, C: ELL, theta=1.02):
    """C without the edges of the rows of A that are strongly diagonally
    dominant, ``|a_ii| > theta * sum_j!=i |a_ij|`` (the diagonal kept), so
    that those nodes stay on the fine level (reference ``utils.py:1627``).
    A BELL is measured on its blocks' largest magnitudes."""
    from pyamg_tpu_torch.ops.rowops import ell_dedup
    from pyamg_tpu_torch.ops.spmv import extract_diagonal
    base = A
    if isinstance(A, BELL):
        from pyamg_tpu_torch.strength import _block_reduce
        base = _block_reduce(A, "abs")
    d = np.abs(extract_diagonal(base))
    offsum = np.sum(np.abs(base.vals), axis=1) - d
    dom = d > theta * offsum
    cols = np.asarray(C.cols)
    isdiag = cols == np.arange(C.shape[0], dtype=np.int32)[:, None]
    keep = C.valid_mask() & (~(dom[:, None] | dom[cols]) | isdiag)
    return ell_dedup(cols, np.where(keep, C.vals, 0), keep, C.shape)


def compute_BtBinv(B, C: ELL):
    """``BtBinv[i] = pinv(B_i^H B_i)`` with B_i the rows of B at the
    pattern of row i of the scalar ELL C (reference ``utils.py:1533``)."""
    from pyamg_tpu_torch.aggregation.energy import compute_BtBinv as _impl
    return _impl(B, C.cols, C.valid_mask())


def filter_operator(A: ELL, C: ELL, B, Bf, BtBinv=None) -> ELL:
    """A restricted to the pattern of C such that ``A @ B = Bf`` still
    holds: each row's values on C's slots are corrected by its l2
    projection, ``A_i <- A_i - (A_i B_i - Bf_i) BtBinv[i] B_i^H``
    (reference ``utils.py:1119``)."""
    from pyamg_tpu_torch.aggregation.energy import compute_BtBinv as _btb
    from pyamg_tpu_torch.ops.rowops import ell_dedup, row_lookup
    B, Bf = np.asarray(B), np.asarray(Bf)
    B = B[:, None] if B.ndim == 1 else B
    Bf = Bf[:, None] if Bf.ndim == 1 else Bf
    pat_cols, pat_valid = np.asarray(C.cols), C.valid_mask()
    if BtBinv is None:
        BtBinv = _btb(B, pat_cols, pat_valid)
    Av = row_lookup(A, pat_cols, pat_valid)
    Bc = np.where(pat_valid[:, :, None], B[pat_cols], 0)
    diff = np.einsum("nw,nwk->nk", Av, Bc) - Bf
    corr = np.einsum("np,npq,nwq->nw", diff, BtBinv, np.conjugate(Bc))
    Av = np.where(pat_valid, Av - corr, 0)
    return ell_dedup(pat_cols, Av, pat_valid & (Av != 0), C.shape,
                     min_width=C.width)


def scale_T(T, Cnodes, pinv_tol=1e-10):
    """T right-scaled so that its root-node (block) rows become identity:
    ``T <- I_F T (P_I^T T)^+ + P_I``, aggregate j rooted at node
    ``Cnodes[j]`` (reference ``utils.py:1275``)."""
    from pyamg_tpu_torch.util.linalg import pinv_array
    rootrows = np.asarray(Cnodes, np.int64)
    nagg = len(rootrows)
    Tc, Tv = np.asarray(T.cols), np.asarray(T.vals)
    hit = (Tc[rootrows] == np.arange(nagg)[:, None]) & \
        T.valid_mask()[rootrows]
    cols = Tc.copy()
    cols[rootrows, 0] = np.arange(nagg, dtype=np.int32)
    if isinstance(T, BELL):
        D = np.einsum("jw,jwab->jab", hit.astype(Tv.dtype), Tv[rootrows])
        Dinv = np.asarray(pinv_array(D))
        vals = np.einsum("nwab,nwbc->nwac", Tv, Dinv[Tc])
        is_root = np.zeros(T.n_block_rows, bool)
        is_root[rootrows] = True
        vals = np.where(is_root[:, None, None, None], 0, vals)
        vals[rootrows, 0] = np.eye(T.blocksize[0], dtype=Tv.dtype)
        rn = np.where(is_root, 1, np.asarray(T.row_nnz)).astype(np.int32)
        return BELL(cols, vals, rn, T.shape, T.blocksize)
    D = np.sum(np.where(hit, Tv[rootrows], 0), axis=1)
    Dinv = np.where(np.abs(D) > pinv_tol, 1.0 / np.where(D == 0, 1, D), 0.0)
    vals = Tv * Dinv[Tc]
    is_root = np.zeros(T.shape[0], bool)
    is_root[rootrows] = True
    vals = np.where(is_root[:, None], 0, vals)
    vals[rootrows, 0] = 1.0
    rn = np.where(is_root, 1, np.asarray(T.row_nnz)).astype(np.int32)
    return ELL(cols, vals, rn, T.shape)


def get_Cpt_params(A, Cnodes, AggOp=None, T=None):
    """Root-node scaffolding (reference ``utils.py:1384``): ``Cpts``, the
    unknowns of the root nodes, ``Fpts`` the others, and ``coarse_id``,
    the coarse column of each C-point (0 elsewhere)."""
    Cnodes = np.asarray(Cnodes)
    bs = A.blocksize[0] if isinstance(A, BELL) else 1
    n = A.shape[0]
    Cpts = (Cnodes[:, None] * bs + np.arange(bs)[None, :]).ravel()
    mask = np.zeros(n, bool)
    mask[Cpts] = True
    coarse_id = np.zeros(n, np.int32)
    coarse_id[Cpts] = np.arange(len(Cpts), dtype=np.int32)
    return {"Cpts": Cpts.astype(np.int32),
            "Fpts": np.where(~mask)[0].astype(np.int32),
            "coarse_id": coarse_id}


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
