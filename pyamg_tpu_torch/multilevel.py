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

``solve`` itself cycles standalone or as the preconditioner of CG.  The
cycle and the loops are Python over tensor ops; the host reads one
convergence flag per iteration.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.krylov.common import norm
from pyamg_tpu_torch.sparse.matrix import DIA, ELL, PhaseStencil, to_scipy
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
    if isinstance(v, ELL):
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


class Level:
    """One grid level: A (and P/R above the coarsest) and smoothers."""

    def __init__(self, A=None, P=None, R=None):
        self.A = A
        self.P = P
        self.R = R
        self.pre = ("none", {}, {})
        self.post = ("none", {}, {})


class CoarseSolver:
    """Coarsest-level solve by a precomputed dense (pseudo-)inverse
    ``params['op']``: the ``'pinv'`` mode of the reference."""

    def __init__(self, kind="pinv"):
        if kind != "pinv":
            raise NotImplementedError(
                f"coarse solver {kind!r} is not ported yet (only 'pinv')")
        self.params = {}

    def setup(self, A):
        self.params = {"op": np.linalg.pinv(to_scipy(A).toarray())}

    def __call__(self, b):
        return self.params["op"] @ b


class MultilevelSolver:
    """Multigrid hierarchy.  ``coarse_solver`` is a kind (set up here
    from the coarsest A) or a ready ``CoarseSolver``."""

    def __init__(self, levels, coarse_solver="pinv"):
        self.levels = levels
        if not isinstance(coarse_solver, CoarseSolver):
            coarse_solver = CoarseSolver(coarse_solver)
            coarse_solver.setup(levels[-1].A)
        self.coarse_solver = coarse_solver
        self.device = None
        self._ds_op = None

    def operator_complexity(self):
        return sum(l.A.nnz for l in self.levels) / self.levels[0].A.nnz

    # -- cycle ---------------------------------------------------------------
    def _make_cycle(self, cycle="V"):
        """cycle(x, b): one multigrid cycle on the current levels."""
        if str(cycle).upper() != "V":
            raise NotImplementedError(
                f"cycle {cycle!r} is not ported yet (only 'V')")
        levels = self.levels
        nlev = len(levels)
        csolve = self.coarse_solver

        def go(lvl, x, b):
            L = levels[lvl]
            x = apply_smoother(*L.pre, L.A, x, b)
            bc = matvec(L.R, b - matvec(L.A, x))
            if lvl == nlev - 2:
                xc = csolve(bc)
            else:
                xc = go(lvl + 1, torch.zeros_like(bc), bc)
            x = x + matvec(L.P, xc)
            return apply_smoother(*L.post, L.A, x, b)

        def cyc(x, b):
            if nlev == 1:
                return csolve(b)
            return go(0, x, b)

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
        cs = CoarseSolver("pinv")
        cs.params = {"op": op}
        self.coarse_solver = cs
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
        inverse and the DS operator onto ``device``; return self."""
        device = resolve(device)

        def put(v):
            if isinstance(v, (DIA, ELL, PhaseStencil, SELL)):
                return v.to(device)
            if isinstance(v, (np.ndarray, torch.Tensor)):
                return as_tensor(v, device)
            return v

        for lvl in self.levels:
            for attr in ("A", "P", "R"):
                setattr(lvl, attr, put(getattr(lvl, attr)))
            for attr in ("pre", "post"):
                kind, sopts, params = getattr(lvl, attr)
                setattr(lvl, attr, (kind, sopts,
                                    {k: put(v) for k, v in params.items()}))
        self.coarse_solver.params = {
            k: put(v) for k, v in self.coarse_solver.params.items()}
        if self._ds_op is not None:
            self._ds_op = {k: put(v) for k, v in self._ds_op.items()}
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
        ``shape``, ``dtype``, ``matvec`` and ``@``."""
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

    def solve(self, b, x0=None, tol=1e-5, maxiter=100, cycle="V",
              accel=None, callback=None, residuals=None, return_info=False):
        """Solve A x = b in the hierarchy's dtype on its device, by
        standalone cycling or, with ``accel="cg"``, by CG preconditioned by
        one cycle.  Stops once ``||b - A x|| < tol * ||b||`` or after
        ``maxiter`` cycles / iterations.  A hierarchy not yet placed moves
        to the card first.  Returns x as a tensor (and ``info``, 0 on
        convergence, else the iteration count, with ``return_info``).

        ``callback(x)`` is called after every cycle or CG iteration;
        ``residuals`` is filled with the residual norms, the initial one
        first."""
        from pyamg_tpu_torch.krylov.methods import cg_loop
        if self.device is None:
            self.to_device()
        A0 = self.levels[0].A
        dtype = A0.dtype
        b = as_tensor(b, self.device, dtype).reshape(-1)
        x = torch.zeros_like(b) if x0 is None else \
            as_tensor(x0, self.device, dtype).reshape(-1)

        def mv(v):
            return matvec(A0, v)

        if accel is not None:
            if accel != "cg":
                raise NotImplementedError(
                    f"accel={accel!r} is not ported yet (only 'cg')")
            x, info, resbuf, nres = cg_loop(
                mv, self.aspreconditioner(cycle).matvec, x, b, tol, "rr",
                maxiter, callback=callback)
            if residuals is not None:
                residuals[:] = resbuf[:nres].tolist()
            return (x, int(info)) if return_info else x

        cyc = self._make_cycle(cycle)
        normb = norm(b)
        rtol = tol * torch.where(normb == 0, 1.0, normb)
        nr = norm(b - mv(x))
        hist = [nr]
        it = 0
        done = bool(nr < rtol)
        while not done and it < maxiter:
            x = cyc(x, b)
            it += 1
            nr = norm(b - mv(x))
            hist.append(nr)
            if callback is not None:
                callback(x)
            done = bool(nr < rtol)
        if residuals is not None:
            residuals[:] = torch.stack(hist).tolist()
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
        ``R_ell``); DIA levels keep K1/K2, which take float64."""
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
        cs = CoarseSolver("pinv")
        cs.params = _cast(self.coarse_solver.params, dtype)
        new = MultilevelSolver(levels, coarse_solver=cs)
        return new if self.device is None else new.to_device(self.device)
