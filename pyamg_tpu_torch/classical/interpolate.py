"""Classical AMG interpolation and restriction operators (counterpart of
``pyamg_tpu/classical/interpolate.py``; setup phase, host ELL and BELL).

Direct, injection and one-point interpolation are vectorised numpy passes
over the ELL rows; the strong F-F filter and (modified) classical
interpolation are the native host core's scalar loops
(``_native/classical.cpp``, float64, P cast back to A's dtype) on a real
operator, and vectorised numpy twins of the reference's, in chunks of
rows, on a complex one (their sign tests on the real part, as the
reference's); lAIR's local systems are batched LAPACK solves on the host,
or with ``use_gmres`` a batched dense GMRES in torch.  A block (BELL)
operator takes injection, one-point interpolation and lAIR, on its
node-level strength, with identity blocks at the C points.
"""

from __future__ import annotations

import warnings

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, ELL, to_scipy
from pyamg_tpu_torch.ops.rowops import ell_dedup, row_lookup
from pyamg_tpu_torch.strength import classical_strength_of_connection

# entries of the (rows, W, W, W) tensors a complex twin makes per chunk
_TWIN_CHUNK = 1 << 22


def _is_complex(*ops):
    return any(np.iscomplexobj(np.asarray(A.vals)) for A in ops)


def _row_chunks(n, per_row):
    """Row ranges of at most ``_TWIN_CHUNK`` entries of ``per_row`` each."""
    step = max(1, _TWIN_CHUNK // max(per_row, 1))
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def _coarse_map(splitting):
    """Coarse index of each C point (exclusive prefix sum) and their
    number."""
    s = np.asarray(splitting, np.int32)
    return np.cumsum(s).astype(np.int32) - s, int(s.sum())


def _strength_pattern(A: ELL, C: ELL):
    """(scols, smask, svals): C's strong off-diagonal pattern carrying A's
    values (reference ``interpolate.py:66-68``)."""
    rows = np.arange(A.shape[0], dtype=np.int32)[:, None]
    cols = np.asarray(C.cols)
    smask = C.valid_mask() & (cols != rows) & (np.asarray(C.vals) != 0)
    return cols, smask, row_lookup(A, cols, smask)


def _row_sums(A: ELL):
    """(diagonal, sum of positive, sum of negative off-diagonals)."""
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    rows = np.arange(A.shape[0], dtype=np.int32)[:, None]
    valid = A.valid_mask()
    isdiag = valid & (cols == rows)
    offd = valid & (cols != rows)
    diag = np.sum(np.where(isdiag, vals, 0), axis=1)
    pos = np.sum(np.where(offd & (np.real(vals) > 0), vals, 0), axis=1)
    neg = np.sum(np.where(offd & (np.real(vals) < 0), vals, 0), axis=1)
    return diag, pos, neg


def _assemble_p(scols, strong_c_mask, pvals, split, cmap, nc, n):
    """P from the F rows' entries at their strong C slots and the identity
    at the C rows."""
    is_c = split == 1
    fmask = strong_c_mask & ~is_c[:, None]
    cand_cols = np.concatenate([cmap[scols], cmap[:, None]], axis=1)
    cand_vals = np.concatenate(
        [np.where(fmask, pvals, 0),
         np.where(is_c, 1.0, 0.0).astype(pvals.dtype)[:, None]], axis=1)
    cand_valid = np.concatenate([fmask, is_c[:, None]], axis=1)
    return ell_dedup(cand_cols, cand_vals, cand_valid, (n, nc))


def direct_interpolation(A: ELL, C: ELL, splitting, theta=None, norm="min"):
    """Direct interpolation (reference ``interpolate.py:12`` /
    ``ruge_stuben.h:777,832``): F-point weights
    ``w_ij = -(sum_neg / strong_neg) / a_ii * a_ij``, split by the sign
    of the real part; C points injected."""
    if theta is not None:
        C = classical_strength_of_connection(A, theta=theta, norm=norm)
    split = np.asarray(splitting, np.int32)
    cmap, nc = _coarse_map(split)
    n = A.shape[0]

    scols, smask, svals = _strength_pattern(A, C)
    strongC = smask & (split[scols] == 1)
    ssp = np.sum(np.where(strongC & (np.real(svals) > 0), svals, 0), axis=1)
    ssn = np.sum(np.where(strongC & (np.real(svals) < 0), svals, 0), axis=1)
    diag, sap, san = _row_sums(A)

    no_pos = ssp == 0
    diag = np.where(no_pos, diag + sap, diag)
    alpha = np.where(ssn != 0, san / np.where(ssn == 0, 1, ssn), 0.0)
    beta = np.where(no_pos, 0.0, sap / np.where(ssp == 0, 1, ssp))
    neg_c = -alpha / diag
    pos_c = -beta / diag
    pvals = np.where(np.real(svals) < 0, neg_c[:, None] * svals,
                     pos_c[:, None] * svals)
    return _assemble_p(scols, strongC, pvals, split, cmap, nc, n)


def remove_strong_FF_connections(A: ELL, C: ELL, splitting):
    """C with the strong F-F connections that share no strong C point
    zeroed (reference ``ruge_stuben.h:1133``): the native scan on real
    values, the reference's vectorised twin (``interpolate.py:122-136``),
    in chunks of rows, on complex ones."""
    split = np.asarray(splitting, np.int32)
    if not _is_complex(C):
        from pyamg_tpu_torch import _native
        drop = _native.remove_strong_ff_ell(
            np.asarray(C.cols), np.asarray(C.vals), np.asarray(C.row_nnz),
            split)
        return ELL(C.cols, np.where(drop, 0, np.asarray(C.vals)),
                   C.row_nnz, C.shape)
    cols, vals = np.asarray(C.cols), np.asarray(C.vals)
    n, W = cols.shape
    valid = C.valid_mask()
    smask = valid & (cols != np.arange(n, dtype=np.int32)[:, None]) & \
        (vals != 0)
    ff = smask & (split == 0)[:, None] & (split[cols] == 0)
    c_slot = smask & (split[cols] == 1)          # strong C slots of a row
    strong = valid & (vals != 0)
    drop = np.zeros_like(ff)
    for lo, hi in _row_chunks(n, W * W * W):
        cc = cols[lo:hi]
        kcols = cols[cc]                          # (rows, W, Wk) neighbours
        kvalid = strong[cc]
        eq = kcols[:, :, :, None] == cc[:, None, None, :]
        common = np.any(eq & kvalid[:, :, :, None] &
                        c_slot[lo:hi, None, None, :], axis=(2, 3))
        drop[lo:hi] = ff[lo:hi] & ~common
    return ELL(C.cols, np.where(drop, 0, vals), C.row_nnz, C.shape)


def classical_interpolation(A: ELL, C: ELL, splitting, theta=None,
                            norm="min", modified=True):
    """Distance-1 (modified) classical interpolation (reference
    ``interpolate.py:86`` / ``ruge_stuben.h:1239``): the native two-hop
    pass on real values, the reference's vectorised twin
    (``interpolate.py:172-211``), in chunks of rows, on complex ones."""
    from pyamg_tpu_torch import _native
    if theta is not None:
        C = classical_strength_of_connection(A, theta=theta, norm=norm)
    split = np.asarray(splitting, np.int32)
    if modified:
        C = remove_strong_FF_connections(A, C, split)
    cmap, nc = _coarse_map(split)
    n = A.shape[0]
    if _is_complex(A, C):
        return _classical_twin(A, C, split, cmap, nc, modified)
    ccols = np.asarray(C.cols)
    cvals = np.asarray(C.vals)
    smask = C.valid_mask() & \
        (ccols != np.arange(n, dtype=np.int32)[:, None]) & (cvals != 0)
    nsc = (smask & (split[ccols] == 1)).sum(axis=1)
    p_cols, p_vals, p_nnz = _native.classical_interpolation_ell(
        np.asarray(A.cols), np.asarray(A.vals), np.asarray(A.row_nnz),
        ccols, cvals, np.asarray(C.row_nnz), split, cmap, modified,
        max(int(nsc.max(initial=0)), 1))
    return ELL(p_cols, p_vals.astype(np.asarray(A.vals).dtype), p_nnz,
               (n, nc))


def _classical_twin(A, C, split, cmap, nc, modified):
    """Classical interpolation as the reference's vectorised numpy pass
    (``interpolate.py:172-211``), for complex values: the (rows, W, WA,
    W) two-hop tensors are made a chunk of rows at a time."""
    n = A.shape[0]
    scols, smask, svals = _strength_pattern(A, C)
    strongC = smask & (split[scols] == 1)
    strongF = smask & (split[scols] == 0)
    diag, sap, san = _row_sums(A)
    denom = (diag + sap + san) - np.sum(np.where(smask, svals, 0), axis=1)
    acols, avals = np.asarray(A.cols), np.asarray(A.vals)
    avalid = A.valid_mask()
    rows = np.arange(n, dtype=np.int32)[:, None]
    d = np.sum(np.where(avalid & (acols == rows), avals, 0), axis=1)
    W, WA = scols.shape[1], acols.shape[1]
    numer = np.empty_like(svals)
    for lo, hi in _row_chunks(n, W * WA * W):
        sc = scols[lo:hi]
        a_kk = d[sc]                                     # (rows, W)
        eq = acols[sc][:, :, :, None] == sc[:, None, None, :]
        akj = np.sum(np.where(eq & avalid[sc][:, :, :, None],
                              avals[sc][:, :, :, None], 0), axis=2)
        if modified:
            same = np.sign(np.real(akj)) == np.sign(np.real(a_kk))[:, :, None]
            akj = np.where(same, 0, akj)
        inner = np.sum(np.where(strongC[lo:hi, None, :], akj, 0), axis=2)
        a_ik = svals[lo:hi]
        use = (np.abs(akj) > 1e-15 * np.abs(a_ik)[:, :, None]) & \
            strongF[lo:hi, :, None] & (inner[:, :, None] != 0)
        contrib = np.where(
            use, a_ik[:, :, None] * akj /
            np.where(inner[:, :, None] == 0, 1, inner[:, :, None]), 0)
        numer[lo:hi] = a_ik + np.sum(contrib, axis=1)
    pvals = -numer / np.where(denom == 0, 1, denom)[:, None]
    return _assemble_p(scols, strongC, pvals, split, cmap, nc, n)


def injection_interpolation(A, splitting):
    """Injection: C points by value, F rows empty (reference
    ``interpolate.py:174``); on a BELL, identity blocks at the C
    points."""
    split = np.asarray(splitting, np.int32)
    cmap, nc = _coarse_map(split)
    if isinstance(A, BELL):
        bs = A.blocksize[0]
        is_c = split == 1
        vals = np.where(is_c[:, None, None, None],
                        np.eye(bs, dtype=A.dtype)[None, None], 0)
        return BELL(np.where(is_c, cmap, 0)[:, None].astype(np.int32),
                    vals.astype(A.dtype), is_c.astype(np.int32),
                    (A.n_block_rows * bs, nc * bs), (bs, bs))
    is_c = split == 1
    cols = np.where(is_c, cmap, 0)[:, None]
    vals = np.where(is_c, 1.0, 0.0).astype(A.dtype)[:, None]
    return ELL(cols, vals, is_c.astype(np.int32), (A.shape[0], nc))


def one_point_interpolation(A, C: ELL, splitting, by_val=False):
    """One-point interpolation: each F point takes its most strongly
    connected C neighbour (reference ``interpolate.py:241`` /
    ``air.h:46``), with weight 1, or ``-A_fc`` with ``by_val``.  On a
    BELL, the strongest C neighbour of the node-level strength ``C``
    with an identity block (``by_val`` ignored, as in the reference)."""
    split = np.asarray(splitting, np.int32)
    cmap, nc = _coarse_map(split)
    n = C.shape[0]
    block = isinstance(A, BELL)
    M = A if by_val and not block else C
    mcols = np.asarray(M.cols)
    mvals = np.asarray(M.vals)
    smask = M.valid_mask() & (mcols != np.arange(n, dtype=np.int32)[:, None])
    cand = smask & (split[mcols] == 1)
    mag = np.where(cand, np.abs(mvals), -1.0)
    best = np.argmax(mag, axis=1)[:, None]
    has = np.take_along_axis(mag, best, axis=1)[:, 0] >= 0
    bcol = np.take_along_axis(mcols, best, axis=1)[:, 0]
    bval = np.take_along_axis(mvals, best, axis=1)[:, 0]
    is_c = split == 1
    cols = np.where(is_c, cmap, cmap[bcol])[:, None]
    valid = is_c | has
    if block:
        bs = A.blocksize[0]
        vals = np.where(valid[:, None, None, None],
                        np.eye(bs, dtype=A.dtype)[None, None], 0)
        return BELL(np.where(valid[:, None], cols, 0).astype(np.int32),
                    vals.astype(A.dtype), valid.astype(np.int32),
                    (n * bs, nc * bs), (bs, bs))
    val = np.where(is_c, 1.0, -bval if by_val else np.ones_like(bval))
    return ELL(np.where(valid[:, None], cols, 0),
               np.where(valid, val, 0).astype(A.dtype)[:, None],
               valid.astype(np.int32), (n, nc))


# -- lAIR: approximate ideal restriction by local solves ---------------------

def _air_neighborhoods(C: ELL, split, Cpts, degree):
    """(ncp, M) int64: each C point's strong F neighbourhood (distance 1,
    or 2 with ``degree=2``), sorted and padded with -1."""
    S = to_scipy(C).tocsr()
    S.sort_indices()
    indptr, indices = S.indptr, S.indices
    out = []
    for c in Cpts:
        n1 = [j for j in indices[indptr[c]:indptr[c + 1]]
              if split[j] == 0 and j != c]
        s = set(n1)
        if degree == 2:
            for j in n1:
                for k in indices[indptr[j]:indptr[j + 1]]:
                    if split[k] == 0 and k != j:
                        s.add(k)
        out.append(sorted(s))
    M = max(max((len(s) for s in out), default=0), 1)
    nb = np.full((len(out), M), -1, np.int64)
    for i, s in enumerate(out):
        nb[i, :len(s)] = s
    return nb


def _air_systems(A: ELL, nbrs, cpts):
    """The batch of local systems ``A[N, N]^T r = -A[c, N]^T``: (At, b,
    ok), padded neighbourhood slots an identity row and a zero rhs."""
    ncp, M = nbrs.shape
    ok = nbrs >= 0
    nb = np.where(ok, nbrs, 0)
    Ac, Av, rn = (np.asarray(a) for a in (A.cols, A.vals, A.row_nnz))
    n_cols = A.shape[0]
    q = nb.reshape(-1)
    sub = ELL(Ac[q], Av[q], rn[q], (ncp * M, n_cols))
    qc = np.broadcast_to(nb[:, None, :], (ncp, M, M)).reshape(ncp * M, M)
    A_loc = row_lookup(sub, qc).reshape(ncp, M, M)
    subc = ELL(Ac[cpts], Av[cpts], rn[cpts], (ncp, n_cols))
    b = -row_lookup(subc, nb)
    okj = ok[:, :, None] & ok[:, None, :]
    pad_eye = np.where(~ok[:, :, None] & np.eye(M, dtype=bool)[None],
                       np.ones((), A_loc.dtype), 0)
    A_sys = np.where(okj, A_loc, 0) + pad_eye
    return np.swapaxes(A_sys, 1, 2), np.where(ok, b, 0), ok


def _air_solve_host(At, b):
    """Direct solves of the local systems (reference ``air.h:212-328``):
    one batched LAPACK solve, with least squares for the systems that are
    singular."""
    ncp, M, _ = At.shape
    # one singular system makes the whole batched solve raise: give the
    # ones cond() flags the identity and solve them by least squares
    with np.errstate(all="ignore"):
        sing = ~np.isfinite(np.linalg.cond(At))
    A_solve = np.where(sing[:, None, None], np.eye(M, dtype=At.dtype), At)
    try:
        r = np.linalg.solve(A_solve, b[..., None])[..., 0]
    except np.linalg.LinAlgError:
        # cond() can miss an exactly singular system whose LU meets a
        # zero pivot: treat every system as suspect
        sing = np.ones(ncp, dtype=bool)
        r = np.zeros_like(b)
    for i in np.flatnonzero(sing | ~np.isfinite(r).all(axis=1)):
        r[i] = np.linalg.lstsq(At[i], b[i], rcond=None)[0]
    return r


def _dense_gmres_batch(Amat, b, m, precondition=True):
    """Batched dense GMRES(m) from zero on small systems ``Amat r = b``
    (torch tensors; reference ``krylov.h:214`` ``dense_GMRES``, called from
    ``air.h:212-328`` with ``use_gmres``): m Arnoldi steps with classical
    Gram-Schmidt, then least squares in the Krylov basis.
    ``precondition`` scales the rows by the inverse diagonal first."""
    import torch
    if precondition:
        d = torch.diagonal(Amat, dim1=1, dim2=2)
        dinv = torch.where(d.abs() > 1e-32, 1.0 / d, torch.ones_like(d))
        Amat = Amat * dinv[:, :, None]
        b = b * dinv
    nb, mm = b.shape
    V = b.new_zeros((nb, m + 1, mm))
    H = b.new_zeros((nb, m + 1, m))
    beta = torch.linalg.vector_norm(b, dim=1)
    V[:, 0] = b / torch.where(beta == 0, 1, beta)[:, None]
    for j in range(m):
        w = torch.bmm(Amat, V[:, j, :, None])[..., 0]
        for i in range(j + 1):
            hij = (V[:, i].conj() * w).sum(dim=1)
            H[:, i, j] = hij
            w = w - hij[:, None] * V[:, i]
        hn = torch.linalg.vector_norm(w, dim=1)
        H[:, j + 1, j] = hn
        V[:, j + 1] = w / torch.where(hn == 0, 1, hn)[:, None]
    e1 = b.new_zeros((nb, m + 1, 1))
    e1[:, 0, 0] = beta
    # the minimum-norm solution through the SVD, as where H is rank
    # deficient (an early breakdown) every solver must agree
    y = torch.linalg.lstsq(H, e1, driver="gelsd").solution
    return torch.bmm(V[:, :m].transpose(1, 2), y)[..., 0]


def local_air(A: ELL, splitting, theta=0.1, norm="abs", degree=1,
              use_gmres=False, maxiter=10, precondition=True):
    """Local approximate-ideal-restriction (lAIR) operator (reference
    ``interpolate.py:324`` / ``air.h:124-328``): each C point's row solves
    ``r^T A[N, N] = -A[c, N]`` over its strong F neighbourhood N, with 1 at
    the C point.  ``use_gmres`` solves the local systems by dense
    GMRES(``maxiter``, 0 for the full dimension) instead of directly.  A
    BELL takes block lAIR (``_local_air_bsr``), always solved directly."""
    if isinstance(A, BELL):
        if use_gmres:
            warnings.warn("block lAIR always uses the exact batched "
                          "direct solve; use_gmres/maxiter/precondition "
                          "are ignored for BSR operators (at least as "
                          "accurate as the reference's dense_GMRES "
                          "option, block_approx_ideal_restriction_pass2)")
        return _local_air_bsr(A, splitting, theta, norm, degree)
    C = classical_strength_of_connection(A, theta=theta, block=False,
                                         norm=norm)
    split = np.asarray(splitting)
    Cpts = np.flatnonzero(split == 1)
    ncp = len(Cpts)
    n = A.shape[0]
    if ncp == 0:
        return ELL(np.zeros((0, 1), np.int32), np.zeros((0, 1), A.dtype),
                   np.zeros((0,), np.int32), (0, n))
    nbrs = _air_neighborhoods(C, split, Cpts, degree)
    At, b, ok = _air_systems(A, nbrs, Cpts)
    if use_gmres:
        import torch
        M = nbrs.shape[1]
        m = M if int(maxiter) == 0 else min(int(maxiter), M)
        r = _dense_gmres_batch(torch.from_numpy(At), torch.from_numpy(b), m,
                               precondition).numpy()
        # a singular local system gives a non-finite row: that C point's
        # row of R degrades to injection
        r = np.where(np.isfinite(r).all(axis=1, keepdims=True), r, 0)
    else:
        r = _air_solve_host(At, b)
    cand_cols = np.concatenate(
        [np.where(ok, nbrs, 0).astype(np.int32),
         Cpts.astype(np.int32)[:, None]], axis=1)
    cand_vals = np.concatenate([np.where(ok, r, 0),
                                np.ones((ncp, 1), A.dtype)], axis=1)
    cand_valid = np.concatenate([ok & (r != 0), np.ones((ncp, 1), bool)],
                                axis=1)
    return ell_dedup(cand_cols, cand_vals, cand_valid, (ncp, n))


def _block_lookup(A: BELL, rows, cols):
    """The blocks ``A[rows[i], cols[i]]`` (block indices, equal shapes),
    a zero block where A stores none: (..., br, bc)."""
    acols = np.asarray(A.cols).astype(np.int64)
    avals = np.asarray(A.vals)
    nbc = max(A.n_block_cols, 1)
    valid = A.valid_mask()
    keys = (np.arange(acols.shape[0], dtype=np.int64)[:, None] * nbc +
            acols)[valid]
    order = np.argsort(keys, kind="stable")
    keys, stored = keys[order], avals[valid][order]
    q = np.asarray(rows, np.int64) * nbc + np.asarray(cols, np.int64)
    if not len(keys):
        return np.zeros(q.shape + A.blocksize, avals.dtype)
    idx = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
    hit = keys[idx] == q
    return np.where(hit[..., None, None], stored[idx], 0).astype(avals.dtype)


def _local_air_bsr(A: BELL, splitting, theta, norm, degree):
    """Block lAIR (reference ``interpolate.py:481-530`` / ``air.h:379``):
    the node-level neighbourhoods of the block strength; each C point's
    rows solve the local system of blocksize x |N| unknowns, as one
    batched LAPACK solve per neighbourhood size (least squares where a
    system is singular); the C point's identity block after its
    neighbours."""
    bs = A.blocksize[0]
    C = classical_strength_of_connection(A, theta=theta, block=True,
                                         norm=norm)
    split = np.asarray(splitting)
    Cpts = np.flatnonzero(split == 1)
    ncp = len(Cpts)
    nb = A.n_block_rows
    dtype = np.asarray(A.vals).dtype
    if ncp == 0:
        return BELL(np.zeros((0, 1), np.int32), np.zeros((0, 1, bs, bs),
                                                         dtype),
                    np.zeros((0,), np.int32), (0, nb * bs), (bs, bs))
    nbrs = _air_neighborhoods(C, split, Cpts, degree)
    sizes = (nbrs >= 0).sum(axis=1)
    W = int(sizes.max()) + 1
    cols = np.zeros((ncp, W), np.int32)
    vals = np.zeros((ncp, W, bs, bs), dtype)
    for m in np.unique(sizes):
        at = np.flatnonzero(sizes == m)
        N = nbrs[at, :m]                                   # (k, m)
        c = Cpts[at]
        if m:
            # A[N, N] and -A[c, N] as dense (k, bs m, bs m), (k, bs, bs m)
            blocks = _block_lookup(A, N[:, :, None], N[:, None, :])
            A0 = blocks.transpose(0, 1, 3, 2, 4).reshape(len(at), m * bs,
                                                          m * bs)
            brow = -_block_lookup(A, np.broadcast_to(c[:, None], N.shape),
                                  N).transpose(0, 2, 1, 3).reshape(
                                      len(at), bs, m * bs)
            At, rhs = np.swapaxes(A0, 1, 2), np.swapaxes(brow, 1, 2)
            try:
                r = np.linalg.solve(At, rhs)
            except np.linalg.LinAlgError:
                r = np.empty_like(rhs)
                for i in range(len(at)):
                    try:
                        r[i] = np.linalg.solve(At[i], rhs[i])
                    except np.linalg.LinAlgError:
                        r[i] = np.linalg.lstsq(At[i], rhs[i],
                                               rcond=None)[0]
            r = np.swapaxes(r, 1, 2)                       # (k, bs, bs m)
            cols[at, :m] = N
            vals[at, :m] = r.reshape(len(at), bs, m, bs).transpose(0, 2, 1,
                                                                   3)
        cols[at, m] = c
        vals[at, m] = np.eye(bs, dtype=dtype)
    return BELL(cols, vals, (sizes + 1).astype(np.int32),
                (ncp * bs, nb * bs), (bs, bs))
