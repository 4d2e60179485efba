"""The JAX package's root-node, pairwise and adaptive SA paths on the CPU:
the numbers the port's ``families:`` phase of ``chip_smoke.py`` is held
to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_families_reference.py

builds three hierarchies of 2-D Poisson 500^2 in the JAX package, with the
SELL levels of ``jax_sell_reference.sellify`` (the layouts
``compress_stencils`` makes where Pallas runs) and its SELL kernels in
interpret mode (``use_interpret``), and prints one JSON line each:

* RN: ``rootnode_solver(A, max_coarse=50)`` in float64 (energy-minimising
  prolongation smoothing), ``solve_refined(tol=1e-10, accel="cg")``;
* PW: ``pairwise_solver(A, max_coarse=50)`` in float32,
  ``solve_refined(tol=1e-10, accel="cg", inner_maxiter=60,
  max_outer=20)``;
* aSA: ``adaptive_sa_solver(A, num_candidates=1, max_coarse=50)`` in
  float64, solved as PW; its line also holds ``work``, and for each trial
  hierarchy the setup built its rows and the factor rho first measured
  on it (None for a trial never cycled).

b comes from ``default_rng(0)``.  Each line holds the rows of the levels,
the operator complexity, the layout of each level's (A, P, R), the
diagonals of each DIA level, the (kind, t, passes, Sy) of each SELL
operator, the outer count, the inner iterations of each outer, the true
relative residual in float64 and the setup time.  ``--small`` runs 48^2
instead (the card-against-CPU solves of the phase).  It runs with
``jax_enable_x64``, as the tests do.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from jax_classical_reference import describe
from jax_sell_reference import record_inner, sellify, use_interpret


def run(name, A, b, build, **solve_kw):
    """Build with ``build(A)`` (a hierarchy, or ``(ml, extra)``), sellify,
    solve, and describe."""
    from pyamg_tpu.sparse.matrix import to_scipy
    S = to_scipy(A).tocsr().astype(np.float64)
    t0 = time.perf_counter()
    built = build(A)
    setup = time.perf_counter() - t0
    ml, extra = built if isinstance(built, tuple) else (built, {})
    sellify(ml)
    out = {"config": name, **describe(ml), **extra}
    inner = record_inner(ml)
    hist = []
    t0 = time.perf_counter()
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, accel="cg", residuals=hist,
                         **solve_kw)
    out.update(outer=len(hist) - 1, inner=list(inner),
               true_relres=float(np.linalg.norm(b - S @ np.asarray(x)) /
                                 np.linalg.norm(b)),
               setup_s=setup, solve_s=time.perf_counter() - t0,
               device=jax.devices()[0].platform)
    return out


def adaptive_trials(A, **kw):
    """``adaptive_sa_solver(A, **kw)`` with each trial hierarchy it builds
    recorded: ``(ml, {"work", "trials": [{"rows", "rho"}]})``.  rho is
    the factor first measured on the trial, as the setup measures it,
    ``(||x|| / ||x0||)^(1 / iters)`` after ``iters`` V-cycles on A x = 0
    from x0 (None for a trial never cycled)."""
    import pyamg_tpu.aggregation.adaptive as adaptive
    build, trials = adaptive.smoothed_aggregation_solver, []

    def recording(*args, **kwargs):
        ml = build(*args, **kwargs)
        trial = {"rows": [int(l.A.shape[0]) for l in ml.levels], "rho": None}
        trials.append(trial)
        solve = ml.solve

        def measured(b, x0=None, maxiter=None, **skw):
            x = solve(b, x0=x0, maxiter=maxiter, **skw)
            if trial["rho"] is None:
                trial["rho"] = (float(jnp.linalg.norm(x)) /
                                float(jnp.linalg.norm(x0))) ** (1.0 / maxiter)
            return x

        ml.solve = measured
        return ml

    adaptive.smoothed_aggregation_solver = recording
    try:
        ml, work = adaptive.adaptive_sa_solver(A, **kw)
    finally:
        adaptive.smoothed_aggregation_solver = build
    ml.__dict__.pop("solve", None)
    return ml, {"work": work, "trials": trials}


def families(N):
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import pairwise_solver, rootnode_solver
    A64 = poisson((N, N))
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    capped = {"inner_maxiter": 60, "max_outer": 20}
    yield run(f"rootnode_poisson_{N}", A64, b,
              lambda A: rootnode_solver(A, max_coarse=50))
    yield run(f"pairwise_poisson_{N}", A64.astype(jnp.float32), b,
              lambda A: pairwise_solver(A, max_coarse=50), **capped)
    yield run(f"adaptive_poisson_{N}", A64, b,
              lambda A: adaptive_trials(A, num_candidates=1, max_coarse=50),
              **capped)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    use_interpret()
    for line in families(48 if "--small" in sys.argv else 500):
        print(json.dumps(line), flush=True)
