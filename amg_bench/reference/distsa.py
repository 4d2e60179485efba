"""Plain reference of the distributed smoothed aggregation
(``poisson2d_distsa``): the hierarchy built in NumPy and SciPy by the
configuration's rules on the whole operator, and its V-cycle-preconditioned
CG in plain PyTorch in one dtype throughout.  The float64 reference is
what the program is held to; the same solve in bfloat16 is the control (the
precision below the float32 that the configuration states).  Imports
nothing of the program.

The rules, as ``distributed_sa_setup`` states them: symmetric strength
with theta 0 (every stored off-diagonal entry is strong); distance-2 Luby
MIS on the strength graph with the priority ``(row * 2654435761 mod 2^32)
>> 1``, at most 24 rounds; 3 rounds of label propagation (each unlabelled
node takes the label of its strongest labelled neighbour, the first of
equal weights), the nodes still unlabelled made roots; coarse ids in the
order of the roots; unit tentative columns; P = (I - omega D^-1 A) T with
omega = (4/3) / rho(D^-1 A) by 12 power iterations; R = P^T, Ac = R A P;
``n // coarse_ratio`` coarse rows a level, the slots past the aggregates
identity rows; coarsening until a level has at most ``coarsen_until``
rows; the coarsest solved by its dense inverse (the program's
pseudo-inverse of an SPD operator); V(2, 2) with damped Jacobi at each
level's omega.  The program also cuts rows of P, R and Ac to fixed widths
(a few hundred entries dropped at 1414^2); the reference keeps every
entry."""

import numpy as np
import scipy.sparse as sp
import torch

from amg_bench.reference.ell import Ell


def mis_priority(rows):
    return ((rows.astype(np.int64) * 2654435761) & 0xFFFFFFFF) >> 1


def _strong_graph(A):
    """The strength graph: every stored non-zero off-diagonal entry."""
    C = A.tocoo()
    keep = (C.row != C.col) & (C.data != 0)
    S = sp.csr_matrix((np.abs(C.data[keep]), (C.row[keep], C.col[keep])),
                      shape=A.shape)
    S.sort_indices()
    return S


def _nb_max(S, x, fill=-1):
    """max over each node and its strong neighbours of x."""
    n = S.shape[0]
    counts = np.diff(S.indptr)
    vals = x[S.indices]
    out = np.full(n, fill, x.dtype)
    has = counts > 0
    if vals.size:
        red = np.maximum.reduceat(vals, S.indptr[:-1][has])
        out[has] = red
    return np.maximum(x, out)


def aggregate(A, max_rounds=24, rounds=3):
    """(labels: the root row of each node's aggregate or -1, roots mask)."""
    S = _strong_graph(A)
    n = A.shape[0]
    rows = np.arange(n)
    eligible = np.diff(S.indptr) > 0
    w0 = mis_priority(rows)
    active = eligible.copy()
    roots = np.zeros(n, bool)
    it = 0
    while active.any() and it < max_rounds:
        wa = np.where(active, w0, -1)
        mk = _nb_max(S, _nb_max(S, wa))
        roots |= active & (wa == mk) & (wa >= 0)
        rk = _nb_max(S, _nb_max(S, roots.astype(np.int64)))
        active &= rk < 1
        it += 1
    lab = np.where(roots, rows, -1)
    counts = np.diff(S.indptr)
    has = counts > 0
    starts = S.indptr[:-1][has]
    pos = np.arange(S.nnz)
    for _ in range(rounds):
        labs = lab[S.indices]
        score = np.where(labs >= 0, S.data, -np.inf)
        best = np.full(n, -np.inf)
        if score.size:
            best[has] = np.maximum.reduceat(score, starts)
        row_of = np.repeat(rows, counts)
        hit = np.isfinite(score) & (score == best[row_of])
        first = np.full(n, S.nnz)
        if score.size:
            first[has] = np.minimum.reduceat(np.where(hit, pos, S.nnz),
                                             starts)
        take = (lab < 0) & eligible & (first < S.nnz)
        lab = np.where(take, labs[np.minimum(first, max(S.nnz - 1, 0))],
                       lab)
    strag = eligible & (lab < 0)
    roots |= strag
    lab = np.where(strag, rows, lab)
    return lab, roots


def power_rho(A, iters=12, seed=0):
    """rho(D^-1 A) by normalised power iteration from a seeded start."""
    dinv = 1.0 / A.diagonal()
    x = np.random.default_rng(seed).standard_normal(A.shape[0])
    x /= np.linalg.norm(x)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (A @ x)
        ny = np.linalg.norm(y)
        lam = ny / max(np.linalg.norm(x), 1e-30)
        x = y / max(ny, 1e-30)
    return float(lam)


def hierarchy(A, coarsen_until=4096, coarse_ratio=4, omega=4.0 / 3.0,
              max_levels=10, seed=0):
    """The levels of A (float64 CSR): dicts with ``A``, ``omega``, ``nagg``
    and (all but the last) ``P``."""
    levels = []
    A = A.tocsr()
    for lvl_i in range(max_levels):
        n = A.shape[0]
        if n <= coarsen_until or n // coarse_ratio < 1:
            break
        c_cap = n // coarse_ratio
        om = omega / max(power_rho(A, seed=seed + lvl_i), 1e-30)
        lab, roots = aggregate(A)
        cid_of_root = np.cumsum(roots) - 1
        nagg = int(roots.sum())
        on = lab >= 0
        cid = np.minimum(cid_of_root[lab[on]], c_cap - 1)
        T = sp.csr_matrix((np.ones(int(on.sum())), (np.flatnonzero(on), cid)),
                          shape=(n, c_cap))
        dinv = 1.0 / A.diagonal()
        P = (T - sp.diags(om * dinv) @ (A @ T)).tocsr()
        P.eliminate_zeros()
        Ac = (P.T @ A @ P).tocsr()
        unused = np.arange(nagg, c_cap)
        Ac = (Ac + sp.csr_matrix((np.ones(unused.size), (unused, unused)),
                                 shape=Ac.shape)).tocsr()
        Ac.sort_indices()
        levels.append({"A": A, "P": P, "omega": om, "nagg": nagg})
        A = Ac
    om = 1.0 / max(power_rho(A, seed=seed + 99), 1e-30)
    levels.append({"A": A, "omega": om, "nagg": None})
    return levels


def describe(levels):
    return {"levels": len(levels),
            "rows": [int(l["A"].shape[0]) for l in levels],
            "nagg": [l["nagg"] for l in levels[:-1]]}


class Solver:
    """V(nu, nu)-preconditioned CG on ``levels`` in ``dtype`` on
    ``device`` (float64: the reference; bfloat16: the control)."""

    def __init__(self, levels, device, dtype, nu=2):
        self.dtype, self.device, self.nu = dtype, device, nu

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   device=device).to(dtype)
        self.levels = [{"A": Ell(l["A"], device, dtype),
                        "dinv": vec(1.0 / l["A"].diagonal()),
                        "omega": l["omega"],
                        "P": Ell(l["P"], device, dtype),
                        "R": Ell(l["P"].T.tocsr(), device, dtype)}
                       for l in levels[:-1]]
        self.coarse = vec(np.linalg.inv(levels[-1]["A"].toarray()))
        self.A0 = Ell(levels[0]["A"], device, dtype)

    def _smooth(self, L, x, b):
        for _ in range(self.nu):
            x = x + L["omega"] * L["dinv"] * (b - L["A"].mv(x))
        return x

    def cycle(self, b, level=0):
        if level == len(self.levels):
            return self.coarse @ b
        L = self.levels[level]
        x = self._smooth(L, torch.zeros_like(b), b)
        r = b - L["A"].mv(x)
        x = x + L["P"].mv(self.cycle(L["R"].mv(r), level + 1))
        return self._smooth(L, x, b)

    def solve(self, b, tol, maxiter):
        """(x as float64 numpy, iterations): CG from zero, stopped once
        ||r|| <= tol ||b|| (recursive residual) or after ``maxiter``."""
        b = torch.as_tensor(np.asarray(b, np.float64),
                            device=self.device).to(self.dtype)
        bnorm = float(torch.linalg.vector_norm(b.float())) or 1.0
        x = torch.zeros_like(b)
        r = b.clone()
        z = self.cycle(r)
        p = z
        rz = torch.dot(r, z)
        it = 0
        while it < maxiter and \
                float(torch.linalg.vector_norm(r.float())) > tol * bnorm:
            Ap = self.A0.mv(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.cycle(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return x.double().cpu().numpy(), it
