"""Energy-minimising prolongation smoothing (counterpart of
``pyamg_tpu/aggregation/energy.py``; setup phase, numpy).

P lives on a sparsity pattern fixed up front, ``Atilde^degree @
pattern(T)``, so every Krylov iterate is an ``(n, W)`` array of values on
the pattern's slots: the product ``A @ X`` restricted to the pattern is
``ops.spgemm.masked_spgemm``, the constraint ``U @ B = 0`` a row-local
projection with ``BtBinv[i] = pinv(B_i^H B_i)``, and the inner products
are Frobenius dots over the flat values.  The minimisation runs in the
operator's dtype from start to end.  A block (BELL) operator runs through
the same scalar core after unamalgamation.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import (BELL, ELL, bell_from_scipy,
                                           from_scipy, to_scipy)
from pyamg_tpu_torch.ops.arith import add
from pyamg_tpu_torch.ops.rowops import ell_dedup, row_lookup
from pyamg_tpu_torch.ops.spgemm import masked_spgemm, spgemm
from pyamg_tpu_torch.ops.spmv import extract_diagonal
from pyamg_tpu_torch.ops.transpose import transpose
from pyamg_tpu_torch.util.linalg import pinv_array
from pyamg_tpu_torch.util.utils import (filter_matrix_rows, filter_operator,
                                        truncate_rows, unamal)


# -- building blocks ---------------------------------------------------------

def _on_pattern(B, pat_cols, pat_valid):
    """(n, W, k): the rows of B at each pattern slot, 0 off the pattern."""
    return np.where(pat_valid[:, :, None], np.asarray(B)[pat_cols], 0)


def compute_BtBinv(B, pat_cols, pat_valid):
    """``BtBinv[i] = pinv(B_i^H B_i)``, B_i the rows of B at the pattern of
    row i."""
    Bc = _on_pattern(B, pat_cols, pat_valid)
    return pinv_array(np.einsum("nwp,nwq->npq", np.conjugate(Bc), Bc))


def satisfy_constraints(Uvals, B, BtBinv, pat_cols, pat_valid):
    """U (values on the pattern) projected row by row so that U @ B = 0."""
    Bc = _on_pattern(B, pat_cols, pat_valid)
    UB = np.einsum("nw,nwk->nk", Uvals, Bc)
    corr = np.einsum("np,npq,nwq->nw", UB, BtBinv, np.conjugate(Bc))
    return np.where(pat_valid, Uvals - corr, 0)


def _ones_of(A: ELL, dtype) -> ELL:
    """The pattern of A with 1 on every stored entry."""
    return ELL(A.cols, np.where(A.valid_mask(), 1.0, 0.0).astype(dtype),
               A.row_nnz, A.shape)


def _pattern_from(A: ELL, T: ELL, Atilde: ELL, degree, prefilter) -> ELL:
    """P's pattern: ``Atilde^degree @ pattern(T)``, with the optional
    ``theta`` and ``k`` row filters of ``prefilter``."""
    pattern = _ones_of(T, T.dtype)
    if degree > 0:
        S = _ones_of(Atilde, T.dtype)
        for _ in range(degree):
            pattern = spgemm(S, pattern)
    prefilter = dict(prefilter or {})
    if prefilter.get("theta") == 0:
        prefilter.pop("theta")
    if "theta" in prefilter and "k" in prefilter:
        p_theta = filter_matrix_rows(pattern, prefilter["theta"])
        pattern = add(truncate_rows(pattern, prefilter["k"]), p_theta)
    elif "k" in prefilter:
        pattern = truncate_rows(pattern, prefilter["k"])
    elif "theta" in prefilter:
        pattern = filter_matrix_rows(pattern, prefilter["theta"])
    elif prefilter:
        raise ValueError("Unrecognized prefilter option")
    live = pattern.valid_mask() & (pattern.vals != 0)
    return ell_dedup(pattern.cols, np.where(live, 1.0, 0.0).astype(T.dtype),
                     live, pattern.shape)


def _weight_vector(A: ELL, weighting):
    """The row preconditioner 1 / D: D the diagonal (``'diagonal'``,
    ``'block'``) or the |A| row sums (``'local'``)."""
    if weighting in ("diagonal", "block"):
        d = extract_diagonal(A)
    elif weighting == "local":
        d = np.sum(np.abs(A.vals), axis=1)
    else:
        raise ValueError("weighting value is invalid")
    return np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0).astype(
        A.dtype)


def _lookup_on_pattern(T: ELL, pat_cols, pat_valid):
    """T's values at the pattern's slots (T's pattern a subset of it)."""
    return row_lookup(T, pat_cols, pat_valid)


# -- the minimisations (state: values on the pattern's slots) ----------------

class _Masked:
    """``A @ V`` restricted to the pattern, for V given by its values on
    the pattern (an ``n x nc`` operator)."""

    def __init__(self, A, pat_cols, pat_valid, nc):
        self.A, self.cols, self.valid = A, pat_cols, pat_valid
        self.rn = pat_valid.sum(axis=1).astype(np.int32)
        self.shape = (pat_cols.shape[0], nc)

    def __call__(self, Vv):
        return masked_spgemm(self.A, ELL(self.cols, Vv, self.rn, self.shape),
                             self.cols, self.valid)


def _cg_loop(op, Tv, Dinv, maxiter, tol):
    """``maxiter`` preconditioned CG steps on ``op(T) = 0`` from T, with the
    reference's mask: a step whose ``<R, D^-1 R>`` is not above tol (or
    whose ``<P, op(P)>`` is 0) moves nothing, and the search direction
    goes on from it, so the iterate is the reference's step for step."""
    R = -op(Tv)
    P = np.zeros_like(R)
    oldsum = np.zeros((), R.real.dtype)
    for it in range(maxiter):
        Z = R * Dinv[:, None]
        newsum = np.real(np.vdot(R, Z))
        P = Z if it == 0 else \
            Z + (newsum / (oldsum if oldsum != 0 else 1)) * P
        AP = op(P)
        pap = np.vdot(P, AP)
        alpha = newsum / pap if (pap != 0 and newsum > tol) else 0
        alpha = np.asarray(alpha, R.dtype)
        Tv = Tv + alpha * P
        R = R - alpha * AP
        oldsum = newsum
    return Tv


def _gmres_min(op, Tv, maxiter):
    """GMRES on ``op(U) = -op0(T)`` in the flat pattern-value space with the
    Frobenius inner product (reference ``smooth.py:648``): one cycle of
    ``maxiter`` Arnoldi steps, stopped early at a breakdown."""
    R = op(Tv, rhs=True)
    beta = float(np.sqrt(np.real(np.vdot(R, R))))
    if beta == 0 or not np.isfinite(beta):
        return Tv
    Vs = [R / np.asarray(beta, R.dtype)]
    cplx = np.iscomplexobj(Tv)
    H = np.zeros((maxiter + 1, maxiter), complex if cplx else float)
    k_eff = 0
    for j in range(maxiter):
        W = op(Vs[j])
        for i in range(j + 1):
            h = np.vdot(Vs[i], W)
            H[i, j] = complex(h) if cplx else float(np.real(h))
            W = W - np.asarray(H[i, j], W.dtype) * Vs[i]
        H[j + 1, j] = float(np.sqrt(np.real(np.vdot(W, W))))
        k_eff = j + 1
        if H[j + 1, j] < 1e-14 * beta:
            break
        Vs.append(W / np.asarray(H[j + 1, j], W.dtype))
    e1 = np.zeros(k_eff + 1, H.dtype)
    e1[0] = beta
    y, *_ = np.linalg.lstsq(H[:k_eff + 1, :k_eff], e1, rcond=None)
    upd = np.zeros_like(Tv)
    for i in range(k_eff):
        upd = upd + np.asarray(y[i], Tv.dtype) * Vs[i]
    return Tv + upd


# -- the smoother -----------------------------------------------------------

def _scalar_of(M):
    return from_scipy(to_scipy(M).tocsr()) if isinstance(M, BELL) else M


def energy_prolongation_smoother(A, T, Atilde, B, Bf=None,
                                 Cpt_params=(False, {}), krylov="cg",
                                 maxiter=4, tol=1e-8, degree=1,
                                 weighting="local", prefilter=None,
                                 postfilter=None):
    """Energy-minimising prolongation smoothing (reference ``smooth.py:875``):
    ``maxiter`` steps of ``krylov`` (``'cg'``, ``'cgnr'`` or ``'gmres'``)
    on ``A P = 0`` within P's pattern (``degree`` products of Atilde's
    pattern with T's) and the constraint ``P @ B = T @ B``, each row
    weighted by ``weighting``.  ``Cpt_params = (True, {'Cpts',
    'coarse_id', ...})`` keeps identity rows at the C-points (root-node
    SA); ``prefilter``/``postfilter`` take ``theta`` and ``k``, the
    postfilter followed by one re-smoothing pass.  A BELL A or T runs
    through the scalar core and returns a BELL of T's blocksize."""
    if maxiter < 0:
        raise ValueError("maxiter must be > 0")
    if tol > 1:
        raise ValueError("tol must be <= 1")

    if isinstance(A, BELL) or isinstance(T, BELL):
        A_e, T_e = _scalar_of(A), _scalar_of(T)
        bs = T.blocksize if isinstance(T, BELL) else (1, 1)
        # the node-level strength expanded to scalar rows
        if Atilde is not None and Atilde.shape[0] != A_e.shape[0]:
            Atilde = unamal(Atilde, A_e.shape[0] // Atilde.shape[0],
                            A_e.shape[1] // Atilde.shape[1])
        P_e = energy_prolongation_smoother(
            A_e, T_e, Atilde, B, Bf, Cpt_params, krylov, maxiter, tol,
            degree, weighting, prefilter, postfilter)
        return bell_from_scipy(to_scipy(P_e).tobsr(blocksize=bs))

    B = np.asarray(B)
    if B.shape[0] != T.shape[1]:
        raise ValueError("B is the candidates for the coarse grid; "
                         "num_rows(B) = num_cols(T)")
    if min(T.nnz, A.nnz) == 0:
        return T
    if Atilde is None:
        Atilde = _ones_of(A, A.dtype)

    n = A.shape[0]
    pattern = _pattern_from(A, T, Atilde, degree, prefilter)
    use_cpts = bool(Cpt_params[0])
    cmask = np.zeros(n, bool)
    if use_cpts:
        # a C-point's row holds one slot, at its coarse column
        coarse_id = np.asarray(Cpt_params[1]["coarse_id"])
        cmask[np.asarray(Cpt_params[1]["Cpts"])] = True
        p_cols = np.asarray(pattern.cols).copy()
        p_rn = np.asarray(pattern.row_nnz).copy()
        p_cols[cmask, 0] = coarse_id[cmask]
        p_cols[cmask, 1:] = 0
        p_rn[cmask] = 1
        pattern = ELL(p_cols, (np.arange(pattern.width)[None, :] <
                               p_rn[:, None]).astype(A.dtype),
                      p_rn, pattern.shape)

    pat_cols, pat_valid = np.asarray(pattern.cols), pattern.valid_mask()
    B = B.astype(A.dtype)
    if B.ndim == 1:
        B = B[:, None]
    BtBinv = compute_BtBinv(B, pat_cols, pat_valid)

    postfilter = dict(postfilter or {})
    if (use_cpts and B.shape[1] > 1) or "secondpass" in postfilter:
        T = filter_operator(T, pattern, B, Bf, BtBinv)

    Tv = _lookup_on_pattern(T, pat_cols, pat_valid).astype(A.dtype)
    Dinv = _weight_vector(A, weighting)
    # rows held to the identity by the root nodes take no update
    cfix = (~cmask).astype(A.dtype)

    masked = _Masked(A, pat_cols, pat_valid, B.shape[0])

    def constrain(Uv):
        return satisfy_constraints(Uv, B, BtBinv, pat_cols, pat_valid) * \
            cfix[:, None]

    if krylov == "cg":
        Tv = _cg_loop(lambda V: constrain(masked(V)), Tv, Dinv, maxiter, tol)
    elif krylov == "cgnr":
        AH = transpose(A, conjugate=True)
        normal = _Masked(AH, pat_cols, pat_valid, B.shape[0])

        def op(V):
            # A^H (A V), both products restricted to the pattern
            return constrain(normal(masked(V)))

        Tv = _cg_loop(op, Tv, Dinv, maxiter, tol)
    elif krylov == "gmres":
        def op(V, rhs=False):
            U = masked(V) * Dinv[:, None]
            return constrain(-U if rhs else U)

        Tv = _gmres_min(op, Tv, maxiter)
    else:
        raise ValueError(f"unknown krylov method {krylov!r}")

    if use_cpts:
        # the C-points' rows exactly the identity again
        ident = pat_cols == coarse_id[:, None]
        Tv = np.where(cmask[:, None], np.where(ident, 1.0, 0.0),
                      Tv).astype(A.dtype)

    P = ell_dedup(pat_cols, Tv, pat_valid & (Tv != 0), pattern.shape)

    # the postfilter (root-node only), then one re-smoothing pass
    if not postfilter or "secondpass" in postfilter or not use_cpts:
        return P
    if "theta" in postfilter and "k" in postfilter:
        T_theta = filter_matrix_rows(P, postfilter["theta"])
        T_k = truncate_rows(P, postfilter["k"])
        mask = add(_ones_of(T_theta, P.dtype), _ones_of(T_k, P.dtype))
        vals = row_lookup(P, mask.cols, mask.valid_mask())
        T_filter = ell_dedup(mask.cols, vals,
                             mask.valid_mask() & (vals != 0), P.shape)
    elif "k" in postfilter:
        T_filter = truncate_rows(P, postfilter["k"])
    elif "theta" in postfilter:
        T_filter = filter_matrix_rows(P, postfilter["theta"])
    else:
        raise ValueError("Unrecognized postfilter option")
    return energy_prolongation_smoother(
        A, T_filter, Atilde, B, Bf, Cpt_params, krylov=krylov, maxiter=1,
        tol=1e-8, degree=0, weighting=weighting, prefilter={},
        postfilter={"secondpass": True})
