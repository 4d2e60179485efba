"""Plain reference of the grid smoothed-aggregation main path
(``poisson2d_gridsa``): the hierarchy built in SciPy from the grid, and
the solve (float32-style inner CG preconditioned by a V(1,1) cycle of
symmetric multicolor Gauss-Seidel, outer residual corrections) in plain
PyTorch, in one dtype throughout.  The float64 reference is what the
program is held to; the same code in float32 is the control, the step a
later change would be tempted to take (dropping the double-single outer
residual).  Imports nothing of the program.

The rules are PyAMG's ``smoothed_aggregation_solver`` with
``aggregate='grid'`` as the configuration states them: 3 x 3 box
aggregates of the tensor grid; candidates improved by 4 symmetric
Gauss-Seidel sweeps on A x = 0 from ones; tentative columns normalised
over each aggregate; P = (I - (4/3) / rho(D^-1 A) D^-1 A) T; Galerkin
R = P^T, Ac = R A P; coarsening while a level has more than ``max_coarse``
rows; the cycle cut at the first level of at most ``collapse_n`` rows,
solved there by its dense inverse (LU: the coarse operator is SPD)."""

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from amg_bench.reference.ell import Ell
from amg_bench.reference.poisson import poisson2d


def grid_colors(m, nine_point):
    """A coloring of the m x m grid's rows: red-black for the 5-point
    stencil, the four parities of (i, j) for the 9-point stencils of the
    coarse levels."""
    i, j = np.divmod(np.arange(m * m), m)
    if nine_point:
        return 2 * (i % 2) + (j % 2), 4
    return (i + j) % 2, 2


def check_coloring(A, colors):
    """Whether no off-diagonal entry of A joins two rows of one color."""
    C = sp.coo_matrix(A)
    off = C.row != C.col
    return not np.any(colors[C.row[off]] == colors[C.col[off]])


def symmetric_order(ncolors):
    """The color passes of one symmetric sweep, a color repeated back to
    back taken once (with omega 1 the second pass changes nothing)."""
    seq = list(range(ncolors)) + list(range(ncolors))[::-1]
    return [seq[0]] + [c for k, c in enumerate(seq[1:]) if c != seq[k]]


def _host_gs(A, x, b, colors, ncolors, sweeps):
    """Symmetric multicolor Gauss-Seidel in SciPy (the candidates' sweeps
    of the set-up)."""
    dinv = 1.0 / A.diagonal()
    rows = [np.flatnonzero(colors == c) for c in range(ncolors)]
    parts = [A[r] for r in rows]
    for _ in range(sweeps):
        for c in symmetric_order(ncolors):
            r = rows[c]
            x[r] += dinv[r] * (b[r] - parts[c] @ x)
    return x


def _rho_dinv_a(A):
    """The largest eigenvalue of D^-1 A, from D^-1/2 A D^-1/2, to a
    relative 1e-3 (Lanczos from a seeded random start; the program's
    estimate stops at 1e-2)."""
    d = 1.0 / np.sqrt(A.diagonal())
    S = sp.diags(d) @ A @ sp.diags(d)
    if S.shape[0] <= 64:
        return float(np.linalg.eigvalsh(S.toarray()).max())
    v0 = np.random.default_rng(0).random(S.shape[0]) - 0.5
    return float(spla.eigsh(S, k=1, which="LA", tol=1e-3, v0=v0,
                            return_eigenvectors=False)[0])


def hierarchy(n, dtype=np.float64, max_coarse=10, max_levels=10,
              omega=4.0 / 3.0, improve_sweeps=4):
    """The levels of 2-D Poisson n^2: a list of dicts with ``A`` (CSR),
    the grid side ``m``, and (all but the last) ``P``."""
    A = poisson2d(n, dtype)
    B = np.ones(n * n, dtype)
    levels = [{"A": A, "m": n}]
    while len(levels) < max_levels and levels[-1]["A"].shape[0] > max_coarse:
        lvl = levels[-1]
        A, m = lvl["A"], lvl["m"]
        cm = -(-m // 3)
        if cm * cm >= m * m:
            break
        colors, nc = grid_colors(m, len(levels) > 1)
        B = _host_gs(A, B.copy(), np.zeros_like(B), colors, nc,
                     improve_sweeps)
        i, j = np.divmod(np.arange(m * m), m)
        agg = (i // 3) * cm + (j // 3)
        norms = np.sqrt(np.bincount(agg, weights=B.astype(np.float64) ** 2,
                                    minlength=cm * cm)).astype(dtype)
        T = sp.csr_matrix((B / norms[agg], (np.arange(m * m), agg)),
                          shape=(m * m, cm * cm), dtype=dtype)
        dinv = (1.0 / A.diagonal()).astype(dtype)
        w = dtype(omega / _rho_dinv_a(A))
        P = (T - sp.diags(dinv * w) @ (A @ T)).tocsr()
        Ac = (P.T @ A @ P).tocsr()
        Ac.sort_indices()
        lvl["P"] = P
        B = norms
        levels.append({"A": Ac, "m": cm})
    return levels


def describe(levels):
    """Levels, rows and stored non-zeros of each level (explicit zeros
    left out), as the comparison takes them."""
    nnz = []
    for lvl in levels:
        A = lvl["A"].copy()
        A.eliminate_zeros()
        nnz.append(int(A.nnz))
    return {"levels": len(levels),
            "rows": [int(l["A"].shape[0]) for l in levels], "nnz": nnz}


class Solver:
    """The solve of the configuration on ``levels``, in ``dtype`` on
    ``device`` (float64: the reference; float32: the control)."""

    def __init__(self, levels, device, dtype, collapse_n=4096):
        k = next((i for i, l in enumerate(levels)
                  if l["A"].shape[0] <= collapse_n), len(levels) - 1)
        if k == 0:
            k = len(levels) - 1
        self.dtype, self.device = dtype, device
        self.A0 = Ell(levels[0]["A"], device, dtype)
        self.levels = []
        for i, lvl in enumerate(levels[:k]):
            A = lvl["A"].tocsr()
            colors, nc = grid_colors(lvl["m"], i > 0)
            if not check_coloring(A, colors):
                raise ValueError(f"level {i}: the grid coloring is not valid")
            rows = [np.flatnonzero(colors == c) for c in range(nc)]
            self.levels.append({
                "A": Ell(A, device, dtype),
                "P": Ell(lvl["P"], device, dtype),
                "R": Ell(lvl["P"].T.tocsr(), device, dtype),
                "dinv": torch.as_tensor(1.0 / A.diagonal().astype(np.float64),
                                        device=device).to(dtype),
                "rows": [torch.as_tensor(r, device=device) for r in rows],
                "parts": [Ell(A[r], device, dtype) for r in rows],
                "order": symmetric_order(nc)})
        dense = levels[k]["A"].toarray().astype(np.float64)
        self.coarse = torch.as_tensor(np.linalg.inv(dense),
                                      device=device).to(dtype)

    def _smooth(self, L, x, b):
        for c in L["order"]:
            r = L["rows"][c]
            x[r] += L["dinv"][r] * (b[r] - L["parts"][c].mv(x))
        return x

    def cycle(self, b, level=0):
        """One V(1,1) cycle from zero on b."""
        if level == len(self.levels):
            return self.coarse @ b
        L = self.levels[level]
        x = self._smooth(L, torch.zeros_like(b), b)
        r = b - L["A"].mv(x)
        x = x + L["P"].mv(self.cycle(L["R"].mv(r), level + 1))
        return self._smooth(L, x, b)

    def cg(self, b, tol, maxiter):
        """Preconditioned CG from zero: (x, iterations), stopped once the
        recursive residual is below tol * ||b||."""
        x = torch.zeros_like(b)
        r = b.clone()
        z = self.cycle(r)
        p = z
        rz = torch.dot(r, z)
        limit = tol * float(torch.linalg.vector_norm(b))
        it = 0
        while it < maxiter and float(torch.linalg.vector_norm(r)) >= limit:
            Ap = self.A0.mv(p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = self.cycle(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        return x, it

    def solve(self, b, tol, inner_tol, inner_maxiter, max_outer):
        """Outer residual corrections, each by CG on the scaled residual:
        (x as float64 numpy, outer corrections, inner CG iterations)."""
        b = torch.as_tensor(np.asarray(b, np.float64),
                            device=self.device).to(self.dtype)
        x = torch.zeros_like(b)
        normb = float(torch.linalg.vector_norm(b)) or 1.0
        r, outer, inner = b, 0, 0
        nr = float(torch.linalg.vector_norm(r))
        while outer < max_outer and not nr <= tol * normb:
            e, it = self.cg(r / nr, inner_tol, inner_maxiter)
            x = x + nr * e
            r = b - self.A0.mv(x)
            nr = float(torch.linalg.vector_norm(r))
            outer += 1
            inner += it
            if not math.isfinite(nr):
                break
        return x.double().cpu().numpy(), outer, inner
