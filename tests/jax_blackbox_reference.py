"""The JAX package's blackbox, Lloyd and Schwarz paths on the CPU: the
numbers the port's ``blackbox:`` phase of ``chip_smoke.py`` is held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_blackbox_reference.py

builds three hierarchies of 2-D Poisson 500^2 in the JAX package and
prints one JSON line each, with b from ``default_rng(0).random``:

* BB: ``solver(A, solver_configuration(A, verb=False))`` in float64
  (evolution strength, energy smoothing by CG, symmetric Gauss-Seidel,
  ``max_coarse=500``, ``pinv``), compressed as ``compress_stencils``
  does where Pallas runs (``jax_sell_reference.sellify``), then
  ``solve(A, b, tol=1e-10, existing_solver=ml, verb=False)``; its line
  also holds the CG iterations (``cg``) and those of a fresh
  ``solve(A, b, tol=1e-8)``, which leaves its hierarchy uncompressed
  (``cg_fresh``, ``fresh_relres``);
* LL: ``smoothed_aggregation_solver(A, aggregate=("lloyd", {}),
  max_coarse=50)`` in float32, sellified, ``solve_refined(tol=1e-10,
  accel="cg", inner_maxiter=60, max_outer=20)`` (the families script's
  ``run``);
* SZ: ``smoothed_aggregation_solver(A, max_coarse=50, keep=True)`` in
  float32 with ``strength_based_schwarz`` pre- and postsmoothing, not
  compressed (the JAX package's Schwarz reads ``A.cols``, which a DIA or
  SELL level has not), solved as LL; its line says whether the solve
  warned that CG takes a non-symmetric preconditioner.

The SELL kernels run in interpret mode (``use_interpret``).  Each line
holds the rows of the levels, the operator complexity, the layout of each
level's (A, P, R), the diagonals of each DIA level, the (kind, t, passes,
Sy) of each SELL operator, the outer count and inner iterations (BB: the
CG count), the true relative residual in float64 and the setup time.
``--small`` runs 48^2 instead.  It runs with ``jax_enable_x64``, as the
tests do.
"""

import json
import sys
import time
import warnings

import numpy as np
import jax
import jax.numpy as jnp

from jax_classical_reference import describe
from jax_families_reference import run
from jax_sell_reference import record_inner, sellify, use_interpret


def relres(S, b, x):
    return float(np.linalg.norm(b - S @ np.asarray(x)) / np.linalg.norm(b))


def blackbox_run(A, b):
    from pyamg_tpu.blackbox import solve, solver, solver_configuration
    from pyamg_tpu.sparse.matrix import to_scipy
    S = to_scipy(A).tocsr()
    t0 = time.perf_counter()
    ml = solver(A, solver_configuration(A, verb=False))
    setup = time.perf_counter() - t0
    timings = {k: round(v, 3) for k, v in ml.setup_timings().items()}
    sellify(ml)
    out = {"config": f"blackbox_poisson_{int(A.shape[0] ** 0.5)}",
           **describe(ml)}
    res = []
    x = solve(A, b, tol=1e-10, existing_solver=ml, verb=False,
              residuals=res)
    fresh = []
    xf = solve(A, b, tol=1e-8, verb=False, residuals=fresh)
    out.update(cg=len(res) - 1, true_relres=relres(S, b, x),
               cg_fresh=len(fresh) - 1, fresh_relres=relres(S, b, xf),
               setup_s=setup, setup_by_key=timings)
    return out


def schwarz_run(name, A, b):
    """SA of the float32 A with strength-based Schwarz smoothing, not
    compressed, solved as ``jax_families_reference.run`` solves PW; its
    line says whether the solve warned."""
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    S = to_scipy(A).tocsr().astype(np.float64)
    schwarz = ("strength_based_schwarz", {})
    t0 = time.perf_counter()
    ml = smoothed_aggregation_solver(A, max_coarse=50, keep=True,
                                     presmoother=schwarz,
                                     postsmoother=schwarz)
    setup = time.perf_counter() - t0
    out = {"config": name, **describe(ml)}
    inner = record_inner(ml)
    hist = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = ml.solve_refined(b, A_fine=S, tol=1e-10, accel="cg",
                             inner_maxiter=60, max_outer=20, residuals=hist)
    out.update(outer=len(hist) - 1, inner=list(inner),
               true_relres=relres(S, b, x), setup_s=setup,
               cg_warning=any("non-symmetric" in str(w.message)
                              for w in caught))
    return out


def paths(N):
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.gallery import poisson
    A64 = poisson((N, N))
    b = np.random.default_rng(0).random(A64.shape[0])
    yield blackbox_run(A64, b)
    A32 = A64.astype(jnp.float32)
    yield run(f"lloyd_poisson_{N}", A32, b,
              lambda A: smoothed_aggregation_solver(
                  A, aggregate=("lloyd", {}), max_coarse=50),
              inner_maxiter=60, max_outer=20)
    yield schwarz_run(f"schwarz_poisson_{N}", A32, b)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    use_interpret()
    for line in paths(48 if "--small" in sys.argv else 500):
        print(json.dumps(line), flush=True)
