"""Multigrid hierarchy and the refined solve (counterpart of
``pyamg_tpu/multilevel.py``).

The setup phase builds every level with numpy arrays on the host.
``compress_stencils`` turns them into the banded / grid-phase / SELL
layouts, ``collapse_coarse`` replaces the coarse tail with a dense
inverse, and ``to_device`` moves the operators and smoother arrays onto
the card.  Two solves run there:

* ``solve_refined``: float64 outer residuals on the host (scipy) around
  ``solve(accel="cg")``, escalating to a float64 twin of the hierarchy
  (``as_dtype``) when refinement stalls;
* ``solve_refined_device``: a double-single outer defect correction on the
  device around float32 CG.

``solve`` itself cycles standalone (V, W, F or AMLI cycles) or as the
preconditioner of a Krylov method (CG, GMRES, FGMRES or any method of
``krylov``).  The cycle, the smoothers and the coarse solvers read
nothing on the host; the loops around them are Python over tensor ops,
and the host reads one convergence flag per iteration.

A hierarchy split over the ranks of a process group
(``parallel.shard_hierarchy``) solves the same way: each rank holds its
block of a sharded level's vectors and the whole of a replicated one's,
the sharded operators gather or exchange their input, and each inner
product of a sharded level is summed over the ranks
(``krylov.common.reduction``), so every rank reads the same stop flags.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.krylov.common import finalize, reduction
from pyamg_tpu_torch.parallel.partition import RowSharded, all_gather
from pyamg_tpu_torch.sparse.matrix import (BELL, DIA, ELL, PhaseStencil,
                                           to_scipy)
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops.spmv import matvec
from pyamg_tpu_torch.relaxation.smoothing import apply_smoother

_NUMPY_FLOAT = {torch.float32: np.float32, torch.float64: np.float64}


def _cast(v, dtype):
    """``v`` (an operator, an array, a tensor or a dict of them) with its
    floating-point data in ``dtype``; integer data stay as they are."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype) if v.is_floating_point() else v
    if isinstance(v, np.ndarray):
        return v.astype(_NUMPY_FLOAT[dtype]) \
            if np.issubdtype(v.dtype, np.floating) else v
    if isinstance(v, DIA):
        return DIA(_cast(v.data, dtype), v.offsets, v.shape)
    if isinstance(v, (ELL, BELL)):
        return dataclasses.replace(v, vals=_cast(v.vals, dtype))
    if isinstance(v, PhaseStencil):
        return dataclasses.replace(
            v, arrays=tuple(_cast(a, dtype) for a in v.arrays))
    if isinstance(v, SELL):
        raise ValueError("SELL is float32 only; a cast needs the level's "
                         "ELL original")
    if isinstance(v, dict):
        return {k: _cast(a, dtype) for k, a in v.items()}
    return v


def _put(v, device):
    """An operator, an array or a dict of them on ``device``; anything
    else (Python scalars, callables) as it is."""
    if isinstance(v, (DIA, ELL, BELL, PhaseStencil, SELL)):
        return v.to(device)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return as_tensor(v, device)
    if isinstance(v, dict):
        return {k: _put(a, device) for k, a in v.items()}
    return v


class Level:
    """One grid level: A (and P/R above the coarsest) and smoothers;
    ``smoother_specs`` keeps the user's (pre, post) specs that built
    them."""

    def __init__(self, A=None, P=None, R=None):
        self.A = A
        self.P = P
        self.R = R
        self.pre = ("none", {}, {})
        self.post = ("none", {}, {})
        self.smoother_specs = None

    @property
    def nnz(self):
        return self.A.nnz


RELAXATION_SOLVERS = ("jacobi", "gauss_seidel", "block_jacobi",
                      "block_gauss_seidel", "schwarz", "none")


class CoarseSolver:
    """Coarsest-level solve, set up once on the host by ``setup(A)`` and
    called as ``(A, b)``.  Kinds: ``pinv``/``pinv2`` (a dense
    pseudo-inverse), ``lu``/``splu`` (LU factors), ``cholesky``,
    ``none`` (zero), a relaxation (``jacobi``, ``gauss_seidel`` and
    their block names on a scalar operator, ``schwarz``; 10 iterations
    from zero by default), ``cg``/``gmres`` (``maxiter`` fixed steps from
    zero, 30 by default) or a callable ``fn(A, b)``.  ``params`` holds the arrays
    ``to_device`` moves; ``static`` the Python values the call branches
    on.  The factor-solves are library calls (triangular solves, which read
    nothing on the host): these systems have at most a few thousand rows,
    and no TPU kernel computes them."""

    def __init__(self, kind="pinv", opts=None):
        if isinstance(kind, tuple):
            kind, opts = kind
        self.kind = kind if kind is not None else "pinv"
        self.opts = dict(opts or {})
        self.params = {}
        self.static = {}

    @classmethod
    def from_factors(cls, kind, factors, opts=None):
        """A solver of ``kind`` from the host factors that ``factor``
        returns (or a producer hands over): ``op`` for pinv, ``lu`` and
        scipy's ``piv`` for LU, ``c`` and ``lower`` of ``cho_factor``, a
        smoother descriptor ``smoother`` for the relaxation kinds,
        ``maxiter`` for cg/gmres, nothing for a callable."""
        cs = cls(kind, opts)
        cs._take(factors)
        return cs

    def setup(self, A):
        self._take(self.factor(A))

    def factor(self, A):
        """The host factors of the coarsest operator A for this kind."""
        kind = self.kind
        if callable(kind):
            return {}
        if kind in ("pinv", "pinv2"):
            return {"op": np.linalg.pinv(to_scipy(A).toarray())}
        if kind in ("lu", "splu"):
            import scipy.linalg
            lu, piv = scipy.linalg.lu_factor(to_scipy(A).toarray())
            return {"lu": lu, "piv": piv}
        if kind == "cholesky":
            import scipy.linalg
            c, lower = scipy.linalg.cho_factor(to_scipy(A).toarray())
            return {"c": c, "lower": lower}
        if kind in RELAXATION_SOLVERS:
            from pyamg_tpu_torch.relaxation.smoothing import make_smoother
            opts = dict(self.opts)
            it = opts.pop("iterations", 10)
            return {"smoother": make_smoother(
                None, A, (kind, {"iterations": it, **opts}))}
        if kind in ("cg", "gmres"):
            return {"maxiter": int(self.opts.get("maxiter", 30))}
        raise ValueError(f"unknown coarse solver {kind!r}")

    def _take(self, f):
        """Lay the factors out as the call reads them: ``params`` (arrays
        that ``to_device`` moves) and ``static`` (Python values)."""
        kind = self.kind
        self.params, self.static = {}, {}
        if callable(kind):
            return
        if kind in ("pinv", "pinv2"):
            self.params = {"op": f["op"]}
        elif kind in ("lu", "splu"):
            self.params = {"lu": f["lu"], "perm": row_permutation(f["piv"])}
        elif kind == "cholesky":
            self.static = {"lower": bool(f["lower"])}
            self.params = {"c": cholesky_triangle(f["c"], f["lower"])}
        elif kind in RELAXATION_SOLVERS:
            skind, sopts, sparams = f["smoother"]
            self.static = {"smoother": (skind, sopts)}
            self.params = {"smoother": sparams}
        elif kind in ("cg", "gmres"):
            self.static = {"maxiter": int(f["maxiter"])}
        else:
            raise ValueError(f"unknown coarse solver {kind!r}")

    def __call__(self, A, b):
        kind = self.kind
        if callable(kind):
            return kind(A, b)
        if kind in ("pinv", "pinv2"):
            return self.params["op"] @ b
        if kind in ("lu", "splu", "cholesky"):
            # two triangular solves: torch.linalg.lu_solve and
            # cholesky_solve check their input on the host
            B = b[:, None] if b.ndim == 1 else b
            if kind == "cholesky":
                c = self.params["c"]
                lower = c if self.static["lower"] else c.mH
                y = torch.linalg.solve_triangular(lower, B, upper=False)
                y = torch.linalg.solve_triangular(lower.mH, y, upper=True)
            else:
                lu = self.params["lu"]
                y = torch.linalg.solve_triangular(
                    lu, B[self.params["perm"]], upper=False,
                    unitriangular=True)
                y = torch.linalg.solve_triangular(lu, y, upper=True)
            return y[:, 0] if b.ndim == 1 else y
        if kind in RELAXATION_SOLVERS:
            k, s = self.static["smoother"]
            return apply_smoother(k, s, self.params["smoother"], A,
                                  torch.zeros_like(b), b)
        from pyamg_tpu_torch.krylov import inner
        if kind == "cg":
            return inner.inner_cg(A, torch.zeros_like(b), b,
                                  self.static["maxiter"])
        if kind == "gmres":
            return inner.inner_gmres(A, torch.zeros_like(b), b,
                                     self.static["maxiter"])
        raise ValueError(f"unknown coarse solver {kind!r}")


def row_permutation(piv):
    """The row order of the factors, ``A[perm] = L U``, from the 0-based
    row interchanges ``piv`` of scipy's ``lu_factor`` (row i swapped with
    row piv[i], for i in order)."""
    perm = np.arange(len(piv))
    for i, p in enumerate(np.asarray(piv)):
        perm[i], perm[p] = perm[p], perm[i]
    return perm


def cholesky_triangle(c, lower):
    """The factor's triangle of ``cho_factor``'s ``c``, whose other
    triangle scipy leaves as it found it."""
    c = np.asarray(c)
    return np.tril(c) if lower else np.triu(c)


def coarse_grid_solver(solver):
    """A ``CoarseSolver`` for ``solver`` (a kind, ``(kind, {opts})`` or a
    callable); ``.setup(A)``, then call it as ``(A, b)``."""
    return CoarseSolver(solver)


class MultilevelSolver:
    """Multigrid hierarchy.  ``coarse_solver`` is a kind (set up here
    from the coarsest A) or a ready ``CoarseSolver``.
    ``symmetric_smoothing`` says whether every level's (pre, post) pair
    makes a symmetric cycle; ``change_smoothers`` sets it."""

    def __init__(self, levels, coarse_solver="pinv"):
        self.levels = levels
        if not isinstance(coarse_solver, CoarseSolver):
            coarse_solver = coarse_grid_solver(coarse_solver)
            coarse_solver.setup(levels[-1].A)
        self.coarse_solver = coarse_solver
        self.symmetric_smoothing = False
        self.device = None
        self._ds_op = None

    # -- complexity ----------------------------------------------------------
    def operator_complexity(self):
        return sum(l.A.nnz for l in self.levels) / self.levels[0].A.nnz

    def grid_complexity(self):
        return sum(l.A.shape[0] for l in self.levels) / \
            self.levels[0].A.shape[0]

    def cycle_complexity(self, cycle="V"):
        """Work of one (1,1) cycle in units of the fine level's non-zeros:
        each visit of a level costs 2 nnz (one smoothing each side), the
        coarsest solve its nnz; AMLI counts as W."""
        cycle = str(cycle).upper()
        nnz = [l.A.nnz for l in self.levels]
        nlev = len(nnz)

        def work(level, kind):
            if nlev == 1:
                return nnz[0]
            if level == nlev - 2:
                return 2 * nnz[level] + nnz[level + 1]
            if kind == "V":
                below = work(level + 1, "V")
            elif kind == "W":
                below = 2 * work(level + 1, "W")
            else:
                below = work(level + 1, "F") + work(level + 1, "V")
            return 2 * nnz[level] + below

        if cycle not in ("V", "W", "F", "AMLI"):
            raise TypeError(f"unrecognized cycle type {cycle!r}")
        return float(work(0, "W" if cycle == "AMLI" else cycle)) / \
            float(nnz[0])

    def setup_timings(self):
        """Setup wall times per phase, summed over the levels (seconds);
        empty where the constructor recorded none."""
        out = {}
        for l in self.levels:
            for k, v in getattr(l, "_setup_timings", {}).items():
                out[k] = out.get(k, 0.0) + v
        return out

    def __repr__(self):
        lines = ["MultilevelSolver",
                 f"Number of Levels:     {len(self.levels)}",
                 f"Operator Complexity: {self.operator_complexity():6.3f}",
                 f"Grid Complexity:     {self.grid_complexity():6.3f}",
                 "  level   unknowns     nonzeros"]
        total = sum(l.A.nnz for l in self.levels)
        for i, l in enumerate(self.levels):
            lines.append(f"{i:6d} {l.A.shape[0]:10d} {l.A.nnz:12d} "
                         f"[{100.0 * l.A.nnz / total:5.2f}%]")
        return "\n".join(lines)

    # -- cycle ---------------------------------------------------------------
    def _make_cycle(self, cycle="V", cycles_per_level=1):
        """cycle(x, b): one multigrid cycle on the current levels.  V
        recurses once; W twice; F once as F, then ``cycles_per_level``
        times as V; AMLI makes two A-orthogonalised corrections from
        cycles of its own.  No host read: the recursion is over Python
        integers and every scalar stays on the device."""
        cycle = str(cycle).upper()
        if cycle not in ("V", "W", "F", "AMLI"):
            raise TypeError(f"unrecognized cycle type {cycle!r}")
        levels = self.levels
        nlev = len(levels)
        csolve = self.coarse_solver

        def go(lvl, x, b, kind):
            L = levels[lvl]
            x = apply_smoother(*L.pre, L.A, x, b)
            bc = matvec(L.R, b - matvec(L.A, x))
            xc = torch.zeros_like(bc)
            if lvl == nlev - 2:
                xc = csolve(levels[-1].A, bc)
            elif kind == "V":
                xc = go(lvl + 1, xc, bc, "V")
            elif kind == "W":
                xc = go(lvl + 1, xc, bc, "W")
                xc = go(lvl + 1, xc, bc, "W")
            elif kind == "F":
                xc = go(lvl + 1, xc, bc, "F")
                for _ in range(cycles_per_level):
                    xc = go(lvl + 1, xc, bc, "V")
            else:
                xc = amli(lvl, xc, bc)
            x = x + matvec(L.P, xc)
            return apply_smoother(*L.post, L.A, x, b)

        def amli(lvl, xc, bc):
            Ac = levels[lvl + 1].A
            dot = reduction(Ac).dot
            ps, bcur = [], bc
            for _ in range(2):
                p = go(lvl + 1, torch.zeros_like(bc), bcur, "AMLI")
                for pj in ps:
                    beta = dot(pj, matvec(Ac, p)) / dot(pj, matvec(Ac, pj))
                    p = p - beta * pj
                Ap = matvec(Ac, p)
                denom = dot(p, Ap)
                alpha = dot(p, bcur) / torch.where(denom == 0, 1, denom)
                xc = xc + alpha * p
                bcur = bcur - alpha * Ap
                ps.append(p)
            return xc

        def cyc(x, b):
            if nlev == 1:
                return csolve(levels[0].A, b)
            return go(0, x, b, cycle)

        return cyc

    # -- setup-phase layouts -------------------------------------------------
    def compress_stencils(self, max_diags=64, sell=True):
        """Square ELL levels with few distinct offsets become ``DIA``;
        grid-tagged P/R become ``PhaseStencil`` (R as the adjoint of the
        stencil of R's transpose); with ``sell``, every other ELL A, P or R
        whose structure allows it becomes ``SELL``.  The originals stay as
        ``A_ell``, ``P_ell`` and ``R_ell``.  Host arrays only: nothing is
        placed.  SELL is built with or without a card: on CPU tensors its
        products and sweeps run their plain versions."""
        from pyamg_tpu_torch.sparse.matrix import (dia_from_ell,
                                                   phase_stencil_from_ell)
        from pyamg_tpu_torch.sparse.sell import sell_from_ell
        from pyamg_tpu_torch.ops.transpose import transpose
        for lvl in self.levels:
            if isinstance(lvl.A, ELL):
                D = dia_from_ell(lvl.A, max_diags=max_diags)
                if D is None and sell:
                    D = sell_from_ell(lvl.A)
                if D is not None:
                    lvl.A_ell, lvl.A = lvl.A, D
            P = lvl.P
            if (isinstance(P, ELL) and P.grid is not None
                    and P.col_grid is not None):
                ps = phase_stencil_from_ell(P, P.grid, P.col_grid)
                if ps is not None:
                    lvl.P_ell, lvl.P = P, ps
                    if isinstance(lvl.R, ELL):
                        rps = phase_stencil_from_ell(transpose(lvl.R),
                                                     P.grid, P.col_grid)
                        if rps is not None:
                            lvl.R_ell = lvl.R
                            lvl.R = dataclasses.replace(rps, trans=True)
            if sell:
                for attr in ("P", "R"):
                    op = getattr(lvl, attr)
                    if isinstance(op, ELL):
                        S = sell_from_ell(op)
                        if S is not None:
                            setattr(lvl, attr + "_ell", op)
                            setattr(lvl, attr, S)
        return self

    def collapse_coarse(self, max_n=4096, device="cuda"):
        """Cut the cycle at the first level with ``n <= max_n`` and solve
        there with its dense inverse, computed on ``device`` and checked
        (an LU inverse off by more than 1e-2 gives way to an SVD
        pseudo-inverse).  The cut levels stay in ``_collapsed_levels``."""
        from pyamg_tpu_torch.ops.dense import inv_device_checked
        k = next((i for i, l in enumerate(self.levels)
                  if l.A.shape[0] <= max_n), len(self.levels) - 1)
        if k == 0 or k >= len(self.levels) - 1:
            return self
        Ak = self.levels[k].A
        op, err, M = inv_device_checked(Ak, device)
        if not bool(torch.isfinite(err)) or float(err) > 1e-2:
            op = torch.linalg.pinv(M, rtol=1e-6)
        self._collapsed_levels = self.levels[k:]
        self.levels = self.levels[:k + 1]
        self.levels[k] = Level(Ak)
        self.coarse_solver = CoarseSolver.from_factors("pinv", {"op": op})
        return self

    def enable_ds_refinement(self, A_fine64=None, device="cuda"):
        """Build the double-single form of the float64 fine operator on
        ``device`` for the outer residuals (``ops/ds.py``).  ``A_fine64``
        defaults to the stored fine ELL in float64."""
        from pyamg_tpu_torch.ops.ds import ds_operator
        if A_fine64 is None:
            A = getattr(self.levels[0], "A_ell", self.levels[0].A)
            A_fine64 = A.astype(np.float64)
        self._ds_op = ds_operator(A_fine64, device=device)
        return self

    def to_device(self, device="cuda"):
        """Move every level's operators and smoother arrays, the coarse
        inverse and the DS operator onto ``device``; return self.  A
        sharded hierarchy stays on its mesh's devices."""
        if self._sharded():
            raise ValueError("a sharded hierarchy lives on its mesh's "
                             "devices; shard_hierarchy placed it")
        device = resolve(device)
        for lvl in self.levels:
            for attr in ("A", "P", "R"):
                setattr(lvl, attr, _put(getattr(lvl, attr), device))
            for attr in ("pre", "post"):
                kind, sopts, params = getattr(lvl, attr)
                setattr(lvl, attr, (kind, sopts, _put(params, device)))
        self.coarse_solver.params = _put(self.coarse_solver.params, device)
        if self._ds_op is not None:
            self._ds_op = _put(self._ds_op, device)
        self.device = device
        return self

    # -- solve ---------------------------------------------------------------
    def solve_refined_device(self, b, tol=1e-10, inner_tol=1e-5,
                             inner_maxiter=30, max_outer=10, cycle="V",
                             residuals=None, iterations_out=None):
        """Solve A x = b to float64 accuracy on the device.

        The outer residual ``b - A x`` is computed in double-single
        float32 arithmetic, the error equation is solved by float32 CG
        preconditioned by one ``cycle`` from zero, and x accumulates in
        double-single.  Stops once ``||r|| <= tol * ||b||`` (norms of the
        float32 high parts) or after ``max_outer`` corrections.  A
        hierarchy not yet placed moves to the card first.  Returns x as
        float64 numpy.

        ``residuals``: filled with the outer residual norms.
        ``iterations_out``: filled with ``{'outer': k, 'inner': total CG
        iterations}``.
        """
        from pyamg_tpu_torch.krylov.methods import cg_loop
        from pyamg_tpu_torch.ops import ds as dsm
        if self._sharded():
            raise NotImplementedError(
                "solve_refined_device on a sharded hierarchy: its "
                "double-single residual takes the whole fine operator; use "
                "solve or solve_refined")
        if self.device is None:
            self.to_device()
        if self._ds_op is None:
            self.enable_ds_refinement(device=self.device)
        A_ds = self._ds_op
        bhi, blo = (as_tensor(v, self.device) for v in
                    dsm.ds_from_f64(np.asarray(b, np.float64).reshape(-1)))
        A0 = self.levels[0].A
        cyc = self._make_cycle(cycle)

        def mv(v):
            return matvec(A0, v)

        def Mv(r):
            return cyc(torch.zeros_like(r), r)

        normb = torch.linalg.vector_norm(bhi)
        normb = torch.where(normb == 0, 1.0, normb)
        nr = torch.linalg.vector_norm(bhi)
        hist = [nr]
        zeros = torch.zeros_like(bhi)
        xhi, xlo, rhi, rlo = zeros, zeros, bhi, blo
        k = itot = 0
        done = bool(nr <= tol * normb)
        while not done and k < max_outer:
            r32 = rhi / torch.where(nr == 0, 1, nr)
            e, _, _, nit = cg_loop(mv, Mv, zeros, r32, inner_tol, "rr",
                                   inner_maxiter)
            xhi, xlo = dsm.ds_add_f32(xhi, xlo, nr * e)
            rhi, rlo = dsm.ds_residual(A_ds, xhi, xlo, bhi, blo)
            nr = torch.linalg.vector_norm(rhi)
            k += 1
            itot += nit - 1
            hist.append(nr)
            done = bool(nr <= tol * normb)
        if residuals is not None:
            residuals[:] = torch.stack(hist).tolist()
        if iterations_out is not None:
            iterations_out["outer"] = k
            iterations_out["inner"] = itot
        return dsm.ds_to_f64(xhi, xlo)

    def aspreconditioner(self, cycle="V"):
        """One ``cycle`` from a zero guess, as a linear operator with
        ``shape``, ``dtype``, ``matvec`` and ``@``.  A hierarchy not yet
        placed moves to the card first."""
        if self.device is None:
            self.to_device()
        cyc = self._make_cycle(cycle)
        A0 = self.levels[0].A

        class _Preconditioner:
            shape = A0.shape
            dtype = A0.dtype

            @staticmethod
            def matvec(r):
                return cyc(torch.zeros_like(r), r)

            def __matmul__(self, r):
                return self.matvec(r)

        return _Preconditioner()

    def psolve(self, b):
        """One V-cycle from zero on b, on the hierarchy's device (on a
        sharded hierarchy b and the result are whole on every rank)."""
        M = self.aspreconditioner()
        return self._gather(M.matvec(self._scatter(b, M.dtype)))

    # -- sharded hierarchies -------------------------------------------------
    def _sharded(self):
        return getattr(self, "_mesh", None) is not None

    def _scatter(self, v, dtype):
        """``v``, whole, as the fine level's vector on this rank: where the
        fine level is sharded, padded with zeros to its padded rows and cut
        to the rank's block."""
        v = as_tensor(v, self.device, dtype).reshape(-1)
        A0 = self.levels[0].A
        if not (isinstance(A0, RowSharded) and A0.out_sharded):
            return v
        mesh, n_pad = A0.mesh, A0.shape[0]
        if v.shape[0] < n_pad:
            v = torch.cat([v, v.new_zeros(n_pad - v.shape[0])])
        n_loc = n_pad // mesh.size
        return v[mesh.rank * n_loc:(mesh.rank + 1) * n_loc].contiguous()

    def _gather(self, x):
        """The fine level's vector x, whole on every rank (one all-gather
        where the fine level is sharded), cut to the unpadded rows."""
        A0 = self.levels[0].A
        if not (isinstance(A0, RowSharded) and A0.out_sharded):
            return x
        return all_gather(x, A0.mesh)[:self._fine_n]

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel=None, callback=None, residuals=None, return_info=False,
              cycles_per_level=1):
        """Solve A x = b in the hierarchy's dtype on its device, by
        standalone cycling or by a Krylov method preconditioned by one
        ``cycle``.  Stops once ``||b - A x|| < tol * ||b||`` (for GMRES,
        the preconditioned residual) or after ``maxiter`` cycles or
        iterations.  A hierarchy not yet placed moves to the card first.
        Returns x as a tensor (and ``info``, 0 on convergence, else the
        iteration count, with ``return_info``).

        ``accel``: None (standalone cycling), ``"cg"`` (``cg_loop``; warns
        when ``symmetric_smoothing`` is False, as CG needs a symmetric
        preconditioner), ``"gmres"``/``"fgmres"`` (``gmres_loop`` with
        classical Gram-Schmidt twice, restart ``min(n, maxiter)``, one
        cycle), the name of another method of ``krylov`` or a callable
        with its interface.  ``cycles_per_level`` (F-cycles' V-cycles per
        level) reaches only standalone cycling: the accelerated solves
        build their cycle with the default, as the reference does.

        ``callback(x)`` is called after every cycle or iteration (every
        GMRES cycle); ``residuals`` is filled with the residual norms, the
        initial one first.  Standalone cycling returns ``info`` 0 when it
        converges on the last allowed cycle.

        On a sharded hierarchy (``parallel.shard_hierarchy``) every rank
        passes the whole b (and x0) and gets the whole x back, after one
        all-gather; ``residuals`` holds the global norms, the same on
        every rank, and ``callback`` gets the rank's block of x.  CG, GMRES
        and FGMRES take their inner products over the ranks; the other
        Krylov methods raise ``NotImplementedError`` there."""
        from pyamg_tpu_torch.krylov.methods import cg_loop
        if self.device is None:
            self.to_device()
        A0 = self.levels[0].A
        dtype = A0.dtype
        b = self._scatter(b, dtype)
        x = torch.zeros_like(b) if x0 is None else self._scatter(x0, dtype)
        red = reduction(A0)

        def mv(v):
            return matvec(A0, v)

        if accel is not None:
            if accel == "cg" and not self.symmetric_smoothing:
                warnings.warn(
                    "Incompatible non-symmetric multigrid preconditioner "
                    "detected, due to presmoother/postsmoother combination. "
                    "CG requires SPD preconditioner, not just SPD matrix.")
            if accel in ("cg", "gmres", "fgmres"):
                Mv = self.aspreconditioner(cycle).matvec
                if accel == "cg":
                    x, info, resbuf, nres = cg_loop(
                        mv, Mv, x, b, tol, "rr", maxiter, callback=callback,
                        red=red)
                else:
                    from pyamg_tpu_torch.krylov.gmres import gmres_loop
                    x, info, resbuf, nres = gmres_loop(
                        mv, Mv, x, b, tol, min(A0.shape[0], int(maxiter)), 1,
                        flexible=accel == "fgmres", callback=callback,
                        red=red)
                finalize(residuals, resbuf, nres)
                if return_info:
                    info = int(info)
            else:
                if isinstance(A0, RowSharded):
                    raise NotImplementedError(
                        f"accel={accel!r} on a sharded hierarchy: only cg, "
                        f"gmres and fgmres take their inner products over "
                        f"the ranks")
                if isinstance(accel, str):
                    from pyamg_tpu_torch import krylov
                    if accel not in krylov.__all__:
                        raise ValueError(f"unknown accel {accel!r}")
                    accel = getattr(krylov, accel)
                x, info = accel(A0, b, x0=x, tol=tol, maxiter=maxiter,
                                M=self.aspreconditioner(cycle),
                                callback=callback, residuals=residuals)
            x = self._gather(x)
            return (x, info) if return_info else x

        cyc = self._make_cycle(cycle, cycles_per_level)
        normb = red.norm(b)
        rtol = tol * torch.where(normb == 0, 1.0, normb)
        nr = red.norm(b - mv(x))
        hist = [nr]
        it = 0
        done = bool(nr < rtol)
        while not done and it < maxiter:
            x = cyc(x, b)
            it += 1
            nr = red.norm(b - mv(x))
            hist.append(nr)
            if callback is not None:
                callback(x)
            done = bool(nr < rtol)         # the one host read of the cycle
        if residuals is not None:
            residuals[:] = torch.stack(hist).tolist()
        x = self._gather(x)
        return (x, 0 if done else it) if return_info else x

    def solve_refined(self, b, A_fine=None, tol=1e-10, inner_tol=1e-5,
                      inner_maxiter=30, max_outer=10, cycle="V", accel="cg",
                      residuals=None, iterations_out=None):
        """Solve A x = b to float64 accuracy: float64 defect correction on
        the host around ``solve`` on the device.

        Each outer step takes ``r = b - A x`` in float64 (scipy), solves
        ``A e = r / ||r||`` in the hierarchy's dtype to ``inner_tol`` and
        adds ``||r|| e`` to x.  Stops once ``||r|| <= tol * ||b||``.  When
        an outer step reduces ``||r||`` by less than 0.7x, the inner solves
        move to a float64 twin of the hierarchy (``as_dtype``, built once);
        a second stall stops with a warning.

        ``A_fine``: the fine operator in float64 (scipy sparse or a host
        ELL/DIA; defaults to the stored fine ELL).  ``residuals``: filled
        with the outer residual norms.  ``iterations_out``: filled with
        ``{'outer': k, 'inner': [iterations of each inner solve]}``.
        Returns x as float64 numpy."""
        import scipy.sparse as sp
        if A_fine is None:
            A_fine = getattr(self.levels[0], "A_ell", self.levels[0].A)
        if not sp.issparse(A_fine):
            A_fine = to_scipy(A_fine)
        As = A_fine.astype(np.float64)
        if self.device is None:
            self.to_device()
        b64 = np.asarray(b, np.float64).reshape(-1)
        n = b64.shape[0]
        x = np.zeros(n, np.float64)
        normb = np.linalg.norm(b64) or 1.0
        hist, inner_its = [], []
        inner = self
        dtype_in = self.levels[0].A.dtype
        for _ in range(max_outer):
            r = b64 - As @ x
            nr = np.linalg.norm(r)
            hist.append(float(nr))
            if nr <= tol * normb:
                break
            if len(hist) > 1 and nr > 0.7 * hist[-2]:
                if inner is self and dtype_in != torch.float64:
                    if getattr(self, "_f64_twin", None) is None:
                        self._f64_twin = self.as_dtype(torch.float64)
                    inner, dtype_in = self._f64_twin, torch.float64
                else:
                    warnings.warn("solve_refined: outer refinement stalled "
                                  f"at relative residual {nr / normb:.2e}")
                    break
            res = []
            e = inner.solve(torch.as_tensor(r / nr, dtype=dtype_in),
                            tol=inner_tol, maxiter=inner_maxiter,
                            cycle=cycle, accel=accel, residuals=res)
            inner_its.append(len(res) - 1)
            x = x + nr * e.cpu().numpy().astype(np.float64)[:n]
        else:
            hist.append(float(np.linalg.norm(b64 - As @ x)))
        if residuals is not None:
            residuals[:] = hist
        if iterations_out is not None:
            iterations_out["outer"] = len(inner_its)
            iterations_out["inner"] = inner_its
        return x

    def as_dtype(self, dtype):
        """A twin of this hierarchy with its floating-point data in
        ``dtype``, placed where this one is.  SELL is float32 only, so the
        twin takes each SELL operator's ELL original (``A_ell``, ``P_ell``,
        ``R_ell``); DIA levels keep K1/K2, which take float64.  A sharded
        hierarchy has no twin: cast it before ``shard_hierarchy``."""
        if self._sharded():
            raise NotImplementedError("as_dtype of a sharded hierarchy: "
                                      "cast it before shard_hierarchy")

        def src(lvl, attr):
            v = getattr(lvl, attr)
            if isinstance(v, SELL):
                v = getattr(lvl, attr + "_ell", v)
            return _cast(v, dtype)

        levels = []
        for lvl in self.levels:
            twin = Level(src(lvl, "A"), src(lvl, "P"), src(lvl, "R"))
            twin.pre = lvl.pre[:2] + (_cast(lvl.pre[2], dtype),)
            twin.post = lvl.post[:2] + (_cast(lvl.post[2], dtype),)
            levels.append(twin)
        old = self.coarse_solver
        cs = CoarseSolver(old.kind, old.opts)
        cs.static = dict(old.static)
        cs.params = _cast(old.params, dtype)
        new = MultilevelSolver(levels, coarse_solver=cs)
        new.symmetric_smoothing = self.symmetric_smoothing
        return new if self.device is None else new.to_device(self.device)

    def change_solve_matrix(self, A):
        """Put the host operator A (an ELL or scipy matrix) in place of
        the fine level's, compressed as the old one was (DIA or SELL where
        it was), and rebuild the fine level's smoothers from the specs
        ``change_smoothers`` kept.  A rebuild that fails raises; the
        float64 twin and the double-single operator of the old matrix are
        dropped.  On a sharded hierarchy a sharded fine level is split
        over the mesh as the old one was (``ShardedELL`` or ``HaloELL``),
        and ``_fine_n`` and the mesh stay."""
        from pyamg_tpu_torch.sparse.matrix import asarray_or_ell, dia_from_ell
        from pyamg_tpu_torch.sparse.sell import sell_from_ell
        from pyamg_tpu_torch.relaxation.smoothing import make_smoother
        lvl = self.levels[0]
        if lvl.smoother_specs is None:
            raise ValueError("the fine level's smoothers were not set by "
                             "change_smoothers, so there is no spec to "
                             "rebuild them from")
        A = asarray_or_ell(A)
        sharded = isinstance(lvl.A, RowSharded)
        shape = (self._fine_n,) * 2 if sharded else lvl.A.shape
        if A.shape != shape:
            raise ValueError(f"A has shape {A.shape}, the fine level "
                             f"{shape}")
        pre, post = (make_smoother(lvl, A, spec)
                     for spec in lvl.smoother_specs)
        op = A
        if sharded:
            from pyamg_tpu_torch.parallel.halo import HaloELL
            from pyamg_tpu_torch.parallel.partition import (
                _check_smoothers, _shard_params, shard_operator)
            _check_smoothers(0, pre, post)
            mesh = lvl.A.mesh
            op = shard_operator(
                A, mesh, "halo" if isinstance(lvl.A, HaloELL) else "gspmd")
            pre, post = (sm[:2] + (_shard_params(sm[2], A.shape[0], mesh),)
                         for sm in (pre, post))
        elif isinstance(lvl.A, DIA):
            op = dia_from_ell(A) or A
        elif isinstance(lvl.A, SELL):
            op = sell_from_ell(A) or A
        if op is not A and not sharded:
            lvl.A_ell = A
        if self.device is not None and not sharded:
            op = _put(op, self.device)
            pre, post = (sm[:2] + (_put(sm[2], self.device),)
                         for sm in (pre, post))
        lvl.A, lvl.pre, lvl.post = op, pre, post
        self._ds_op = None
        self._f64_twin = None
        return self
