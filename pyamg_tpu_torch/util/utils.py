"""Option and operator helpers (counterpart of ``pyamg_tpu/util/utils.py``;
setup phase, numpy): ``levelize``, ``profile_solver``, row and column
scaling, symmetric rescaling, diagonals, amalgamation, rigid-body modes,
the row and column filters, the root-node scaffolding, the hierarchy
spectrum, and the setup clock of the solver constructors."""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch import _trace
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


def profile_solver(ml, accel=None, **kwargs):
    """The residual history of ``ml.solve`` on a right-hand side drawn by
    ``default_rng(0).random`` in the fine operator's dtype (reference
    ``utils.py:51``); ``kwargs`` go to the solve."""
    A = ml.levels[0].A
    b = np.asarray(np.random.default_rng(0).random(A.shape[0]),
                   dtype=_numpy_dtype(A.dtype))
    residuals = []
    ml.solve(b, residuals=residuals, accel=accel, **kwargs)
    return np.asarray(residuals)


def _numpy_dtype(dtype):
    """A numpy dtype for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def scale_rows(A: ELL, v) -> ELL:
    """diag(v) @ A."""
    from pyamg_tpu_torch.ops.arith import scale_rows as _scale_rows
    return _scale_rows(A, np.asarray(v))


def scale_columns(A: ELL, v) -> ELL:
    """A @ diag(v)."""
    return ELL(A.cols, A.vals * np.asarray(v)[np.asarray(A.cols)],
               A.row_nnz, A.shape)


def symmetric_rescaling(A: ELL):
    """``(D^1/2, D^-1/2, D^-1/2 A D^-1/2)`` with D the magnitude of A's
    diagonal (0 in D^-1/2 where the diagonal's real part is 0; reference
    ``utils.py:296``)."""
    from pyamg_tpu_torch.ops.spmv import extract_diagonal
    d = extract_diagonal(A)
    d_sqrt = np.sqrt(np.abs(d))
    d_sqrt_inv = np.where(np.real(d) != 0,
                          1.0 / np.where(d_sqrt == 0, 1, d_sqrt), 0)
    return d_sqrt, d_sqrt_inv, scale_rows(scale_columns(A, d_sqrt_inv),
                                          d_sqrt_inv)


def symmetric_rescaling_sa(A, B, BH=None):
    """``(D^-1/2 A D^-1/2, D^1/2 B, D^1/2 BH)``: the rescaled operator and
    candidates of the same span (reference ``utils.py:371``)."""
    d_sqrt, _, DAD = symmetric_rescaling(A)

    def scaled(V):
        V = np.asarray(V)
        return V * (d_sqrt[:, None] if V.ndim == 2 else d_sqrt)

    return DAD, scaled(B), None if BH is None else scaled(BH)


def get_diagonal(A, norm_eq=False, inv=False):
    """diag(A); with ``norm_eq=1`` diag(A^H A) (the column sums of
    ``|a|^2``), with ``norm_eq=2`` diag(A A^H) (the row sums); with
    ``inv`` their inverses, 0 where 0 (reference ``utils.py:541``)."""
    from pyamg_tpu_torch.ops.spmv import extract_diagonal
    if norm_eq == 1:
        sq = np.abs(np.asarray(A.vals)) ** 2
        d = np.zeros((A.shape[1],), sq.dtype)
        np.add.at(d, np.asarray(A.cols), sq)
    elif norm_eq == 2:
        d = np.sum(np.abs(np.asarray(A.vals)) ** 2, axis=1)
    else:
        d = extract_diagonal(A)
    if inv:
        return np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    return d


def get_block_diag(A: BELL, blocksize=None, inv_flag=False):
    """The (nb, br, bc) diagonal blocks of A, pseudo-inverted with
    ``inv_flag`` (reference ``utils.py:603``)."""
    from pyamg_tpu_torch.ops.spmv import extract_block_diagonal
    from pyamg_tpu_torch.util.linalg import pinv_array
    D = extract_block_diagonal(A)
    return pinv_array(D) if inv_flag else D


def amalgamate(A: ELL, blocksize: int) -> ELL:
    """The node graph of A's ``blocksize x blocksize`` blocks: 1 where a
    block holds an entry (reference ``utils.py:695``)."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
    As = to_scipy(A).tobsr(blocksize=(blocksize, blocksize))
    n = As.shape[0] // blocksize
    return from_scipy(sp.csr_matrix((np.ones(len(As.indices)), As.indices,
                                     As.indptr), shape=(n, n)))


def coord_to_rbm(V):
    """The rigid-body modes of nodes at 1-, 2- or 3-D coordinates V:
    translations, then rotations (about z, then y, then x in 3-D), the
    elasticity near-nullspace (reference ``utils.py:1002``)."""
    V = np.asarray(V)
    n, d = V.shape
    if d == 1:
        return np.ones((n, 1))
    if d == 2:
        B = np.zeros((2 * n, 3))
        B[0::2, 0] = 1
        B[1::2, 1] = 1
        B[0::2, 2] = -V[:, 1]
        B[1::2, 2] = V[:, 0]
        return B
    if d == 3:
        B = np.zeros((3 * n, 6))
        for k in range(3):
            B[k::3, k] = 1
        B[0::3, 3] = -V[:, 1]
        B[1::3, 3] = V[:, 0]
        B[0::3, 4] = V[:, 2]
        B[2::3, 4] = -V[:, 0]
        B[1::3, 5] = -V[:, 2]
        B[2::3, 5] = V[:, 1]
        return B
    raise ValueError("coordinates must be 1D/2D/3D")


def hierarchy_spectrum(ml, filter_entries=True):
    """The eigenvalues of every level's A, densified (with
    ``filter_entries`` its zero rows and their columns dropped), and a
    printed table of their real and imaginary ranges (reference
    ``utils.py:912``).  For small hierarchies."""
    eigs = []
    for lvl in ml.levels:
        Ad = _level_scipy(lvl).toarray()
        if filter_entries:
            keep = np.abs(Ad).sum(axis=1) != 0
            Ad = Ad[np.ix_(keep, keep)]
        eigs.append(np.linalg.eigvals(Ad))
    print("  lvl     n     min(re)      max(re)      min(im)      max(im)")
    for i, e in enumerate(eigs):
        print(f"{i:5d} {e.shape[0]:6d} {e.real.min():12.4e} "
              f"{e.real.max():12.4e} {e.imag.min():12.4e} "
              f"{e.imag.max():12.4e}")
    return eigs


def _level_scipy(lvl):
    """A level's operator as scipy sparse, from its uncompressed original
    where the level keeps one."""
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    from pyamg_tpu_torch.sparse.sell import SELL, sell_to_scipy
    A = getattr(lvl, "A_ell", None)
    A = lvl.A if A is None else A
    return sell_to_scipy(A) if isinstance(A, SELL) else to_scipy(A)


def filter_matrix_columns(A: ELL, theta) -> ELL:
    """A without the entries ``|a_ij| < theta * max_k |a_kj|``, the largest
    magnitude of their column (reference ``utils.py:1932``)."""
    from pyamg_tpu_torch.ops.rowops import ell_dedup
    cols, vals, valid = np.asarray(A.cols), np.asarray(A.vals), \
        A.valid_mask()
    colmax = np.zeros((A.shape[1],))
    np.maximum.at(colmax, cols, np.where(valid, np.abs(vals), 0))
    keep = valid & (np.abs(vals) >= theta * colmax[cols])
    return ell_dedup(cols, np.where(keep, vals, 0), keep, A.shape)


def scale_rows_by_largest_entry(A: ELL) -> ELL:
    """Every row of A divided by its largest magnitude (a zero row kept;
    reference ``utils.py:1746``)."""
    from pyamg_tpu_torch.strength import _scale_rows_by_largest_entry
    return ELL(A.cols, _scale_rows_by_largest_entry(A.vals, A.valid_mask()),
               A.row_nnz, A.shape, A.grid, A.col_grid)


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
    """Wall time of the setup phases of level ``level``, summed by key:
    ``mark(key)`` charges the time since the last mark to ``key`` and
    records it as the span ``setup.<key>`` (``_trace.py``)."""

    def __init__(self, level=None):
        self.times = {}
        self.level = level
        self._t0 = _trace.now()

    def mark(self, key):
        now = _trace.now()
        ns = _trace.add("setup." + key, self._t0, now, level=self.level)
        self.times[key] = self.times.get(key, 0.0) + ns / 1e9
        self._t0 = now
