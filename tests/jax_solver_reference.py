"""The JAX package's iteration counts on the solve paths S1-S6 of
``chip_smoke.py``'s ``solvers:`` phase, on the CPU at full size.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_solver_reference.py

builds each configuration as ``chip_smoke.py`` builds the port's and
prints one JSON line per path (iterations, ``info``, true relative
residual in float64, seconds):

* S1-S5 on 2-D Poisson 500^2, grid SA, ``max_coarse=10``, float64 (in
  float32 no path reaches a true relative residual of 1e-6 at this size:
  ``--float32`` shows where each stops), b from ``default_rng(2022)``:
  S1 GMRES around a W-cycle (symmetric GS, ``collapse_coarse(4096)``); S2 FGMRES around an F-cycle (symmetric SOR
  with omega 1.2, ``coarse_solver="splu"``); S3 CG around a V-cycle
  (Chebyshev of degree 3, ``coarse_solver="cholesky"``); S4 standalone
  AMLI cycling (Jacobi, omega 4/3, 2 iterations, ``maxiter=60``); S5
  ``krylov.bicgstab`` preconditioned by S1's V-cycle.  Each to tol 1e-6.
* S6 on 3-D Poisson 64^3, standard SA, ``max_coarse=50``, b from
  ``default_rng(0)``: SOR forward before and backward after (omega 1.2),
  ``solve_refined(tol=1e-10, accel="gmres", cycle="W")``, with the SELL
  levels and kernels of ``jax_sell_reference`` (interpret mode).

``--small`` runs 96^2 and 24^3 instead (the sizes of the CPU rehearsal).
"""

import json
import sys
import time

import numpy as np
import jax

GS = ("gauss_seidel", {"sweep": "symmetric"})
SOR = ("sor", {"omega": 1.2, "sweep": "symmetric"})
CHEB = ("chebyshev", {"degree": 3})
JAC = ("jacobi", {"omega": 4.0 / 3.0, "iterations": 2})


def _relres(S, b, x):
    x = np.asarray(x, np.float64)[:b.shape[0]]
    return float(np.linalg.norm(b - S @ x) / np.linalg.norm(b))


def poisson2d_runs(N, dtype):
    from pyamg_tpu import krylov
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    A64 = poisson((N, N))
    S = to_scipy(A64)
    A = A64.astype(dtype)
    b = np.random.default_rng(2022).standard_normal(A64.shape[0])

    def build(smoother, collapse=False, **kw):
        ml = smoothed_aggregation_solver(A, aggregate=("grid", {}),
                                         max_coarse=10, presmoother=smoother,
                                         postsmoother=smoother, **kw)
        ml.compress_stencils()
        if collapse:
            ml.collapse_coarse(max_n=4096)
        return ml

    def run(name, fn):
        t0 = time.perf_counter()
        res = []
        x, info = fn(res)
        return {"path": name, "N": N, "dtype": str(A.dtype),
                "iterations": len(res) - 1,
                "info": int(info), "true_relres": _relres(S, b, x),
                "seconds": time.perf_counter() - t0}

    s1 = build(GS, collapse=True)
    out = [run("S1", lambda res: s1.solve(
        b, tol=1e-6, accel="gmres", cycle="W", residuals=res,
        return_info=True))]
    s2 = build(SOR, coarse_solver="splu")
    out.append(run("S2", lambda res: s2.solve(
        b, tol=1e-6, accel="fgmres", cycle="F", residuals=res,
        return_info=True)))
    s3 = build(CHEB, coarse_solver="cholesky")
    out.append(run("S3", lambda res: s3.solve(
        b, tol=1e-6, accel="cg", residuals=res, return_info=True)))
    s4 = build(JAC)
    out.append(run("S4", lambda res: s4.solve(
        b, tol=1e-6, cycle="AMLI", maxiter=60, residuals=res,
        return_info=True)))
    out.append(run("S5", lambda res: krylov.bicgstab(
        s1.levels[0].A, b, tol=1e-6, M=s1.aspreconditioner("V"),
        residuals=res)))
    return out


def poisson3d_run(N):
    import jax.numpy as jnp
    from jax_sell_reference import record_inner, sellify, use_interpret
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    use_interpret()
    A64 = poisson((N, N, N))
    S = to_scipy(A64)
    ml = sellify(smoothed_aggregation_solver(
        A64.astype(jnp.float32), max_coarse=50,
        presmoother=("sor", {"omega": 1.2, "sweep": "forward"}),
        postsmoother=("sor", {"omega": 1.2, "sweep": "backward"})))
    inner = record_inner(ml)
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    hist = []
    t0 = time.perf_counter()
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, accel="gmres", cycle="W",
                         residuals=hist)
    return {"path": "S6", "N": N, "outer": len(hist) - 1, "inner": inner,
            "true_relres": _relres(S, b, x),
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    small = "--small" in sys.argv
    for r in poisson2d_runs(96 if small else 500, np.float32
                            if "--float32" in sys.argv else np.float64):
        print(json.dumps(r), flush=True)
    print(json.dumps(poisson3d_run(24 if small else 64)), flush=True)
