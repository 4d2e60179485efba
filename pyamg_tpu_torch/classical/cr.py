"""Compatible relaxation C/F splitting (counterpart of
``pyamg_tpu/classical/cr.py``; reference ``pyamg/classical/cr.py`` and
``ruge_stuben.h:942`` ``cr_helper``).

CR's convergence measure is *ordering-sensitive*: the reference sweeps with
sequential lexicographic Gauss-Seidel (``relaxation.h:49``), and the
habituated rho it measures under a red-black (multicolor) ordering can land
on the other side of ``thetacr`` for the same C/F set.  The sweeps here
therefore run the exact reference ordering on host (a sparse triangular
solve per sweep) rather than borrowing the device multicolor smoother —
CR is a setup-phase host algorithm anyway.
"""

from __future__ import annotations

import warnings

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL, from_scipy, to_scipy


def _cr_sweep(A: ELL, B, Findex, Cindex, nu, thetacr, method):
    """Habituated/concurrent CR sweeps (reference ``cr.py:12-78``)."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu
    n = A.shape[0]
    As = to_scipy(A).tocsr().astype(np.float64)
    e = np.asarray(B[:, 0], np.float64).copy()
    Cidx = np.asarray(Cindex, np.int64) if len(Cindex) else None
    if method == "habituated":
        LD = sp.tril(As, 0).tocsc()
        U = sp.triu(As, 1).tocsr()
        lu = splu(LD, permc_spec="NATURAL",
                  options={"SymmetricMode": True})
        step = lambda e: lu.solve(-(U @ e))            # noqa: E731
    elif method == "concurrent":
        F = np.asarray(Findex, np.int64)
        AFF = As[F][:, F].tocsr()
        AFC = (As[F].tocsc()[:, Cidx].tocsr()
               if Cidx is not None else None)
        LD = sp.tril(AFF, 0).tocsc()
        UF = sp.triu(AFF, 1).tocsr()
        lu = splu(LD, permc_spec="NATURAL",
                  options={"SymmetricMode": True})

        def step(e):
            rhs = -(UF @ e[F])
            if AFC is not None:
                rhs = rhs - AFC @ e[Cidx]
            out = e.copy()
            out[F] = lu.solve(rhs)
            return out
    else:
        raise NotImplementedError(
            "method not recognized: need habituated or concurrent")
    if Cidx is not None:
        e[Cidx] = 0.0
    enorm = float(np.linalg.norm(e))
    rhok = 1.0
    it = 0
    while True:
        e = step(e)
        if method == "habituated" and Cidx is not None:
            e[Cidx] = 0.0
        enorm_old = enorm
        enorm = float(np.linalg.norm(e))
        rhok_old = rhok
        rhok = enorm / max(enorm_old, 1e-300)
        it += 1
        if rhok < 0.1 * thetacr:
            break
        if (abs(rhok - rhok_old) / max(rhok, 1e-300)) < 0.1 and it >= nu:
            break
    return rhok, np.asarray(e)


def _cr_helper(indptr, indices, target, e, splitting, thetacs):
    """Candidate-set update, steps 3.1d-3.1f of Falgout/Brannick (reference
    ``ruge_stuben.h:942``): measure gamma, pick candidates, then greedy
    weighted independent set promotes candidates to C."""
    n = len(splitting)
    F = np.where(splitting == 0)[0]
    gamma = np.zeros(n)
    em = np.abs(e[F] / np.where(target[F] == 0, 1, target[F]))
    inf_norm = em.max() if len(em) else 0.0
    if inf_norm > 0:
        gamma[F] = em / inf_norm
    U = F[gamma[F] > thetacs]
    omega = np.zeros(n)
    for pt in U:
        nbrs = indices[indptr[pt]:indptr[pt + 1]]
        omega[pt] = np.sum(splitting[nbrs] == 0) + gamma[pt]
    while True:
        new_pt = int(np.argmax(omega))
        if omega[new_pt] <= 0:
            break
        splitting[new_pt] = 1
        gamma[new_pt] = 0
        nbrs = indices[indptr[new_pt]:indptr[new_pt + 1]]
        omega[nbrs] = 0
        for pt in nbrs:
            nn = indices[indptr[pt]:indptr[pt + 1]]
            live = nn[omega[nn] != 0]
            omega[live] += 1
    return splitting


def CR(A: ELL, method="habituated", B=None, nu=3, thetacr=0.7,
       thetacs="auto", maxiter=20, verbose=False):
    """Compatible-relaxation C/F splitting (reference ``cr.py:81-218``)."""
    n = A.shape[0]
    if thetacs != "auto":
        if isinstance(thetacs, float):
            thetacs = [thetacs]
        else:
            thetacs = list(thetacs)
            thetacs.reverse()
        if max(thetacs) >= 1 or min(thetacs) <= 0:
            raise ValueError("Must have 0 < thetacs < 1")
    if thetacr >= 1 or thetacr <= 0:
        raise ValueError("Must have 0 < thetacr < 1")
    if B is None:
        B = np.ones((n, 1))
    B = np.asarray(B, float)
    if B.ndim == 1:
        B = B[:, None]
    target = B[:, 0]

    As = to_scipy(A).tocsr()
    As.sort_indices()
    splitting = np.zeros(n, np.int32)
    Findex = np.arange(n)
    Cindex = np.empty((0,), np.int64)
    rho, e = _cr_sweep(A, B, Findex, Cindex, nu, thetacr, method)
    for it in range(maxiter):
        if thetacs == "auto":
            tcs = 1 - rho
        else:
            tcs = thetacs[-1]
            if len(thetacs) > 1:
                thetacs.pop()
        splitting = _cr_helper(As.indptr, As.indices, target, e,
                               splitting, tcs)
        Findex = np.where(splitting == 0)[0]
        Cindex = np.where(splitting == 1)[0]
        rho, e = _cr_sweep(A, B, Findex, Cindex, nu, thetacr, method)
        if verbose:
            print(f"CR Iteration {it} CF = {rho}, "
                  f"Coarsening factor = {len(Cindex) / n}")
        if rho < thetacr:
            break
    return splitting


def binormalize(A: ELL, tol=1e-5, maxiter=10):
    """Scale A symmetrically toward unit row 1-norms, C = DAD (Livne-Golub;
    reference ``cr.py:221``).  Sequential coordinate updates on host."""
    import scipy.sparse as sp
    As = to_scipy(A).tocsr()
    n = As.shape[0]
    x = np.ones(n)
    B = As.multiply(As).tocsr()
    d = B.diagonal()
    beta = B @ x
    betabar = (1.0 / n) * x.dot(beta)
    stdev = _rowsum_stdev(x, beta)
    it = 0
    while stdev > tol and it < maxiter:
        for i in range(n):
            c2 = (n - 1) * d[i]
            c1 = (n - 2) * (beta[i] - d[i] * x[i])
            c0 = -d[i] * x[i] * x[i] + 2 * beta[i] * x[i] - n * betabar
            if -c0 < 1e-14:
                warnings.warn("A nearly un-binormalizable...")
                return A
            xnew = (2 * c0) / (-c1 - np.sqrt(c1 * c1 - 4 * c0 * c2))
            dx = xnew - x[i]
            ii, jj = B.indptr[i], B.indptr[i + 1]
            dot_Bcol = x[B.indices[ii:jj]].dot(B.data[ii:jj])
            betabar += (1.0 / n) * dx * (dot_Bcol + beta[i] + d[i] * dx)
            beta[B.indices[ii:jj]] += dx * B.data[ii:jj]
            x[i] = xnew
        stdev = _rowsum_stdev(x, beta)
        it += 1
    D = sp.diags_array(np.sqrt(np.abs(x)))
    return from_scipy((D @ As @ D).tocsr())


def _rowsum_stdev(x, beta):
    """Std dev of the scaled row sums relative to the mean (reference
    ``cr.py`` ``rowsum_stdev``)."""
    n = len(x)
    betabar = (1.0 / n) * x.dot(beta)
    stdev = np.sqrt((1.0 / n) * np.sum(np.power(x * beta - betabar, 2)))
    return stdev / max(betabar, 1e-300)
