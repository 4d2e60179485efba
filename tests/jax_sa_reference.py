"""The JAX package's anisotropic and elasticity SA configurations on the
CPU: the numbers the port's ``sa_more:`` phase of ``chip_smoke.py`` is
held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_sa_reference.py

builds the two smoothed-aggregation configurations of ``bench_suite.py``
in the JAX package, with its own ``compress_stencils()``, and prints one
JSON line each:

* anisotropic: ``diffusion_stencil_2d(epsilon=1e-3, theta=pi/8,
  type="FE")`` on a 512^2 grid in float32,
  ``smoothed_aggregation_solver(strength=("evolution", {}),
  aggregate=("grid", {}), max_coarse=20)`` (``bench_suite.py:83-118``);
* elasticity: ``linear_elasticity((100, 100))`` in float32 with its three
  rigid-body modes as B, ``max_coarse=50`` (``bench_suite.py:121-138``);

each solved by ``solve_refined(b, tol=1e-10, inner_maxiter=60,
max_outer=20)`` with b from ``default_rng(0)``.  Each line holds the
rows and blocksize of the levels, the operator complexity, the layout of
each level's (A, P, R), the diagonals of each DIA level, the outer count,
the inner iterations of each outer, the true relative residual in
float64 and the setup time by key.  ``--small`` runs 64^2 and 24^2
instead.  It runs with ``jax_enable_x64``, as the tests do.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from jax_sell_reference import layouts, record_inner


def describe(ml):
    """Rows, blocksizes, complexity, layouts and DIA widths of ``ml``."""
    dia = {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr, None)
            if type(op).__name__ == "DIA":
                dia[f"{attr}{i}"] = len(op.offsets)
    return {"rows": [int(l.A.shape[0]) for l in ml.levels],
            "blocksizes": [list(l.A.blocksize) for l in ml.levels],
            "operator_complexity": float(ml.operator_complexity()),
            "layouts": [list(t) for t in layouts(ml)], "dia": dia}


def run(name, A64, S, build, B=None):
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    t0 = time.perf_counter()
    ml = build(A64.astype(jnp.float32), B)
    setup = time.perf_counter() - t0
    timings = {k: round(v, 3) for k, v in ml.setup_timings().items()}
    ml.compress_stencils()
    out = {"config": name, **describe(ml)}
    inner = record_inner(ml)
    hist = []
    t0 = time.perf_counter()
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, inner_maxiter=60,
                         max_outer=20, residuals=hist)
    out.update(outer=len(hist) - 1, inner=list(inner),
               true_relres=float(np.linalg.norm(b - S @ np.asarray(x)) /
                                 np.linalg.norm(b)),
               setup_s=setup, setup_by_key=timings,
               solve_s=time.perf_counter() - t0,
               device=jax.devices()[0].platform)
    return out


def anisotropic_run(N):
    from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    st = diffusion_stencil_2d(epsilon=1e-3, theta=np.pi / 8, type="FE")
    A64 = stencil_grid(st, (N, N))
    return run(f"anisotropic_{N}", A64, to_scipy(A64),
               lambda A, B: smoothed_aggregation_solver(
                   A, strength=("evolution", {}), aggregate=("grid", {}),
                   max_coarse=20))


def elasticity_run(N):
    from pyamg_tpu.gallery import linear_elasticity
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    A64, B = linear_elasticity((N, N))
    return run(f"elasticity_{N}", A64, to_scipy(A64).tocsr(),
               lambda A, B: smoothed_aggregation_solver(A, B=B,
                                                        max_coarse=50),
               np.asarray(B))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    small = "--small" in sys.argv
    print(json.dumps(anisotropic_run(64 if small else 512)), flush=True)
    print(json.dumps(elasticity_run(24 if small else 100)), flush=True)
