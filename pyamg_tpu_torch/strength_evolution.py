"""Evolution (ODE) strength of connection (counterpart of
``pyamg_tpu/strength_evolution.py``; setup phase, numpy).

Strength is measured by how well the near-nullspace locally approximates
the delta functions evolved by the weighted-Jacobi propagator
``S = ((I - 1/rho(D^-1 A) D^-1 A)^T)^k`` restricted to the pattern of A.
Three routes, as in the reference:

* banded operators with one candidate take ``_evolution_dia_fast``: every
  step is a shifted elementwise product on the (ndiag, n) band;
* otherwise the transposed propagator is squared by SpGEMM, the last
  product kept on A's pattern only (``masked_spgemm``), and a ``k`` that
  is not a power of two takes its extra steps by full products;
* more than one candidate takes the per-row constrained least-squares
  fit of ``_multi_candidate_measure``.
"""

from __future__ import annotations

import warnings

import numpy as np

from pyamg_tpu_torch.sparse.matrix import (BELL, ELL, dia_from_ell,
                                           from_scipy, to_scipy)
from pyamg_tpu_torch.ops.arith import (add, add_scaled_identity, scale_rows,
                                       with_diagonal)
from pyamg_tpu_torch.ops.rowops import ell_dedup, row_lookup
from pyamg_tpu_torch.ops.spgemm import masked_spgemm, spgemm
from pyamg_tpu_torch.ops.spmv import extract_diagonal
from pyamg_tpu_torch.ops.transpose import transpose
from pyamg_tpu_torch.util.linalg import approximate_spectral_radius, pinv_array

_EPS_FLOOR = np.sqrt(np.finfo(float).eps)


def _apply_distance_filter(cols, vals, valid, epsilon):
    """Keep the off-diagonal distances within ``epsilon`` of the row
    minimum, and the diagonal."""
    n = cols.shape[0]
    rows = np.arange(n, dtype=np.int32)[:, None]
    offd = valid & (cols != rows) & (vals != 0)
    mn = np.min(np.where(offd, vals, np.inf), axis=1, keepdims=True)
    keep = (offd & (vals <= epsilon * mn)) | (valid & (cols == rows))
    return np.where(keep, vals, 0), keep


def _shiftv(v, o, n):
    """w[i] = v[i + o], zero outside [0, n).  A shift of n or more is all
    zeros (the reference's slicing fails there: a band wider than half the
    operator, squared)."""
    if o == 0:
        return v.copy()
    w = np.zeros_like(v)
    if abs(o) >= n:
        return w
    if o > 0:
        w[:n - o] = v[o:n]
    else:
        w[-o:n] = v[:n + o]
    return w


def _angle_measure(approx, z):
    """|1 - approx / z| where the candidate approximation points the way
    of z and is not negligible; 0 elsewhere; tiny non-zero values raised
    to 1e-4."""
    angle = (np.real(approx) * np.real(z) + np.imag(approx) * np.imag(z)) < 0
    ratio = approx / np.where(z == 0, 1, z)
    weak = np.abs(ratio) < 1e-4
    v = np.where(weak | angle | (z == 0), 0.0, np.abs(1.0 - ratio))
    return np.where((v < _EPS_FLOOR) & (v != 0), 1e-4, v)


def _evolution_dia_fast(A, Bvec, epsilon, k, symmetrize_measure):
    """The measure of a banded operator with symmetric offsets as shifted
    elementwise products on its (ndiag, n) band: the transposed
    propagator, its squares (the last kept on A's offsets), the
    one-candidate measure, the distance filter, symmetrization and the
    row scaling.  None when A is not such a band or ``k`` is not a power
    of two."""
    if 2 ** int(np.log2(k)) != k:
        return None
    Ad = dia_from_ell(A)
    if Ad is None:
        return None
    offs = [int(o) for o in Ad.offsets]
    if 0 not in offs or set(offs) != {-o for o in offs}:
        return None
    n = A.shape[0]
    data = np.asarray(Ad.data)[:, :n]
    d0 = offs.index(0)
    oidx = {o: d for d, o in enumerate(offs)}

    D = data[d0]
    Dinv = np.where(D != 0, 1.0 / np.where(D == 0, 1, D), 1.0)
    rho = approximate_spectral_radius(scale_rows(A, Dinv))

    # S = (I - 1/rho D^-1 A)^T in band form: S_o[i] = M_{-o}[i + o]
    M = -(1.0 / rho) * (data * Dinv[None, :])
    M[d0] += 1.0
    S = np.stack([_shiftv(M[oidx[-o]], o, n) for o in offs])
    Soffs = list(offs)

    def band_square(Bd, Bo, mask_offs):
        """Bd @ Bd on the offsets ``mask_offs`` (all of them for None)."""
        outo = sorted({o1 + o2 for o1 in Bo for o2 in Bo}
                      if mask_offs is None else mask_offs)
        out = {o: np.zeros(n, Bd.dtype) for o in outo}
        bo = {o: d for d, o in enumerate(Bo)}
        for o1 in Bo:
            for o2 in Bo:
                o = o1 + o2
                if o in out:
                    out[o] += Bd[bo[o1]] * _shiftv(Bd[bo[o2]], o1, n)
        return np.stack([out[o] for o in outo]), outo

    nsquare = int(np.log2(k))
    for s in range(nsquare):
        S, Soffs = band_square(S, Soffs, offs if s == nsquare - 1 else None)
    # band positions outside the grid (i + o outside [0, n)) are no entries
    inb = np.stack([(np.arange(n) + o >= 0) & (np.arange(n) + o < n)
                    for o in offs])
    At = np.where(inb, S, 0)

    Bv = np.where(Bvec == 0, 1.0, Bvec)
    DAdivB = At[d0] / Bv
    vals = np.zeros_like(At)
    for d, o in enumerate(offs):
        vals[d] = _angle_measure(DAdivB * _shiftv(Bv, o, n), At[d])
    vals = np.real(vals)

    if epsilon != np.inf:
        offd = vals.copy()
        offd[d0] = 0
        mn = np.min(np.where(offd != 0, offd, np.inf), axis=0)
        keep = (offd != 0) & (offd <= epsilon * mn[None, :])
        out = np.where(keep, offd, 0)
        out[d0] = vals[d0]
        vals = out

    if symmetrize_measure:
        vals = 0.5 * (vals + np.stack(
            [_shiftv(vals[oidx[-o]], o, n) for o in offs]))
    vals[d0] = 1.0
    vals = np.where(inb, vals, 0)

    iv = np.where(vals != 0, 1.0 / np.where(vals == 0, 1, vals), 0.0)
    rowmax = np.max(np.abs(iv), axis=0)
    iv = iv / np.where(rowmax == 0, 1, rowmax)[None, :]

    rows = np.arange(n, dtype=np.int32)
    cand_cols = np.stack([rows + o for o in offs], axis=1).astype(np.int32)
    cand_vals = iv.T
    cand_ok = inb.T & (cand_vals != 0)
    return ell_dedup(np.where(cand_ok, cand_cols, 0),
                     np.where(cand_ok, cand_vals, 0), cand_ok, A.shape)


def evolution_strength_of_connection(A, B=None, epsilon=4.0, k=2,
                                     proj_type="l2", block_flag=False,
                                     symmetrize_measure=True):
    """Evolution strength of A (a host ELL, or a BELL measured on its
    scalar form and reduced to its block graph, ``_min_blocks``).
    ``B`` the near-nullspace candidates (ones by default), ``epsilon`` the
    drop tolerance against the row minimum, ``k`` the time steps (best a
    power of two), ``proj_type`` the weighting of the multi-candidate fit
    ('l2' or 'D_A')."""
    if epsilon < 1.0:
        raise ValueError("expected epsilon > 1.0")
    if k <= 0:
        raise ValueError("number of time steps must be > 0")
    if proj_type not in ("l2", "D_A"):
        raise ValueError('proj_type must be "l2" or "D_A"')

    numPDEs = 1
    if isinstance(A, BELL):
        numPDEs = A.blocksize[0]
        A = from_scipy(to_scipy(A).tocsr())

    n = A.shape[0]
    Bmat = np.ones((n, 1)) if B is None else np.asarray(B)
    if Bmat.ndim == 1:
        Bmat = Bmat[:, None]
    NullDim = Bmat.shape[1]

    if numPDEs == 1 and NullDim == 1:
        # one candidate never uses proj_type; banded operators take the
        # band route
        fast = _evolution_dia_fast(A, np.asarray(Bmat[:, 0]), epsilon, k,
                                   symmetrize_measure)
        if fast is not None:
            return fast

    D = extract_diagonal(A)
    Dinv = np.where(D != 0, 1.0 / np.where(D == 0, 1, D), 1.0)
    DinvA = scale_rows(A, Dinv)
    rho = approximate_spectral_radius(DinvA)
    # S = (I - 1/rho D^-1 A)^T
    S = transpose(add_scaled_identity(
        scale_rows(DinvA, np.full((n,), -1.0 / rho)), alpha=1.0, beta=1.0))

    # the mask: A's pattern (only the couplings within one PDE of a system)
    mask_valid = A.valid_mask()
    if numPDEs > 1:
        rows = np.arange(n, dtype=np.int32)[:, None]
        mask_valid = mask_valid & ((A.cols % numPDEs) == (rows % numPDEs))
        mask = ell_dedup(A.cols, np.where(mask_valid, 1.0, 0.0), mask_valid,
                         A.shape)
    else:
        mask = ELL(A.cols, np.where(mask_valid, 1.0, 0.0), A.row_nnz,
                   A.shape)

    nsquare = int(np.log2(k))
    ninc = k - 2 ** nsquare
    Atilde = S
    if ninc > 0:
        warnings.warn(
            "The most efficient time stepping for the Evolution Strength "
            f"Method is done in powers of two.\nYou have chosen {k} time "
            "steps.")
        for _ in range(nsquare):
            Atilde = spgemm(Atilde, Atilde)
        for _ in range(ninc):
            Atilde = spgemm(Atilde, S)
        Atilde = ELL(mask.cols, row_lookup(Atilde, mask.cols,
                                           mask.valid_mask()),
                     mask.row_nnz, mask.shape)
    elif nsquare == 0:
        if numPDEs > 1:
            Atilde = ELL(mask.cols, row_lookup(Atilde, mask.cols,
                                               mask.valid_mask()),
                         mask.row_nnz, mask.shape)
    else:
        for _ in range(nsquare - 1):
            Atilde = spgemm(Atilde, Atilde)
        Atilde = ELL(mask.cols, masked_spgemm(Atilde, Atilde, mask.cols,
                                              mask.valid_mask()),
                     mask.row_nnz, mask.shape)

    valid = Atilde.valid_mask()
    if NullDim == 1:
        Bvec = np.where(Bmat[:, 0] == 0, 1.0, Bmat[:, 0])
        DAdivB = extract_diagonal(Atilde) / Bvec
        vals = _angle_measure(DAdivB[:, None] * Bvec[Atilde.cols],
                              Atilde.vals)
    else:
        vals = _multi_candidate_measure(Atilde, Bmat, D, proj_type)
    vals = np.real(vals)
    valid = valid & (vals != 0)

    if epsilon != np.inf:
        vals, valid = _apply_distance_filter(Atilde.cols, vals, valid,
                                             epsilon)

    S_out = ell_dedup(Atilde.cols, vals, valid, Atilde.shape)
    if symmetrize_measure:
        St = transpose(S_out)
        S_out = add(ELL(S_out.cols, 0.5 * S_out.vals, S_out.row_nnz,
                        S_out.shape),
                    ELL(St.cols, 0.5 * St.vals, St.row_nnz, St.shape))
    S_out = with_diagonal(S_out, np.ones((n,)))

    if numPDEs > 1:
        S_out = _min_blocks(S_out, numPDEs)
    return _distances_to_strength(S_out)


def _min_blocks(S: ELL, numPDEs):
    """The node graph of a measure on a system: each (numPDEs x numPDEs)
    block reduced to its smallest non-zero entry, as PyAMG's
    ``min_blocks`` does (the largest float for a block of zeros).  The
    JAX package takes the minimum over the whole block, whose entries
    between two PDEs the PDE-local mask leaves at 0, so that every block
    of its measure becomes 0 and its strength graph empty."""
    import scipy.sparse as sp
    Ss = to_scipy(S).tobsr(blocksize=(numPDEs, numPDEs))
    nb = Ss.shape[0] // numPDEs
    dat = Ss.data.reshape(len(Ss.indices), -1)
    red = np.where(dat != 0, dat, np.finfo(dat.dtype).max).min(axis=1)
    return from_scipy(sp.csr_matrix((red, Ss.indices, Ss.indptr),
                                    shape=(nb, nb)))


def _distances_to_strength(S: ELL):
    """Distances inverted to strengths, each row scaled by its largest."""
    from pyamg_tpu_torch.strength import _scale_rows_by_largest_entry
    iv = np.where(S.vals != 0, 1.0 / np.where(S.vals == 0, 1, S.vals), 0)
    keep = S.valid_mask() & (iv != 0)
    iv = _scale_rows_by_largest_entry(iv, keep)
    return ell_dedup(S.cols, np.where(keep, iv, 0), keep, S.shape)


def _multi_candidate_measure(Atilde: ELL, Bmat, D, proj_type):
    """The measure for more than one candidate: per row i with pattern
    columns J and evolved values z = Atilde[i, J], the weighted
    least-squares fit min_c || W^(1/2) (B[J] c - z) || (W the identity for
    'l2', |D| for 'D_A') by its normal equations, and the pointwise
    measure of the fit B[J] c against z."""
    valid = Atilde.valid_mask()
    z = Atilde.vals
    B = np.asarray(Bmat)
    BJ = np.where(valid[:, :, None], B[Atilde.cols], 0)   # (n, W, K)
    if proj_type == "D_A":
        w = np.where(valid, np.abs(np.asarray(D))[Atilde.cols], 0)
    else:
        w = valid.astype(z.dtype)
    G = np.einsum("nwp,nw,nwq->npq", np.conjugate(BJ), w, BJ)
    rhs = np.einsum("nwp,nw,nw->np", np.conjugate(BJ), w, z)
    c = np.einsum("npq,nq->np", pinv_array(G), rhs)
    return _angle_measure(np.einsum("nwp,np->nw", BJ, c), z)
