"""The JAX package's iteration counts of ``solve(b, accel=m)`` for each
Krylov method m of ``krylov.__all__`` but CG, on the hierarchy of
``chip_smoke.py``'s ``krylov:`` phase, on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_krylov_reference.py

builds S1's hierarchy of ``tests/jax_solver_reference.py`` (2-D Poisson
500^2, grid SA, ``max_coarse=10``, symmetric Gauss-Seidel, compressed,
``collapse_coarse(4096)``, float64; b from ``default_rng(2022)``) and
prints one JSON line per method: ``solve(b, tol=1e-6, accel=m)`` with
the V-cycle and ``maxiter`` 100 (the defaults), its iterations (the
history's length less one), ``info``, the history's last entry, the true
relative residual in float64 and the seconds.  CGNE and CGNR do not
converge here, as ``info`` 100 says; their last residual and true
relative residual are what ``chip_smoke.py`` holds the port's to.  The JAX package's CGNE and CGNR take their
operator's adjoint from an ELL, so they get the fine level's ELL
original (its ``solve`` raises on the compressed level).  ``--small``
runs 96^2.
"""

import json
import sys
import time

import numpy as np
import jax

from jax_solver_reference import GS, _relres

METHODS = ("bicgstab", "cgne", "cgnr", "cr", "minimal_residual",
           "steepest_descent", "gmres", "gmres_mgs", "gmres_householder",
           "fgmres")


def krylov_runs(N):
    import warnings
    from pyamg_tpu import krylov
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    A = poisson((N, N))
    S = to_scipy(A)
    b = np.random.default_rng(2022).standard_normal(A.shape[0])
    ml = smoothed_aggregation_solver(A, aggregate=("grid", {}),
                                     max_coarse=10, presmoother=GS,
                                     postsmoother=GS)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=4096)
    out = []
    for m in METHODS:
        t0 = time.perf_counter()
        res = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if m in ("cgne", "cgnr"):
                # the JAX package's normal equations take an ELL, not the
                # compressed fine level: its solve raises there, so the
                # method gets the level's ELL original, as solve calls it
                x, info = getattr(krylov, m)(
                    ml.levels[0].A_ell, b, x0=np.zeros_like(b), tol=1e-6,
                    maxiter=100, M=ml.aspreconditioner("V"), residuals=res)
            else:
                x, info = ml.solve(b, tol=1e-6, accel=m, residuals=res,
                                   return_info=True)
        out.append({"method": m, "N": N, "iterations": len(res) - 1,
                    "info": int(info), "last_residual": float(res[-1]),
                    "true_relres": _relres(S, b, x),
                    "seconds": time.perf_counter() - t0})
    return out


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    for r in krylov_runs(96 if "--small" in sys.argv else 500):
        print(json.dumps(r), flush=True)
