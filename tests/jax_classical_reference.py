"""The JAX package's classical configurations on the CPU: the numbers the
port's ``classical:`` phase of ``chip_smoke.py`` is held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_classical_reference.py

builds the two classical configurations of ``bench_suite.py`` in the JAX
package, with the SELL levels of ``jax_sell_reference.sellify`` (the
layouts ``compress_stencils`` makes where Pallas runs) and its SELL
kernels in interpret mode (``use_interpret``), and prints one JSON line
each:

* RS: ``ruge_stuben_solver`` on 2-D Poisson 500^2 in float32 with its
  defaults (``bench_suite.py:47-62``), ``solve_refined(tol=1e-10,
  accel="cg")``, b from ``default_rng(0)``;
* AIR: ``air_solver`` on ``advection_2d((256, 256))`` in float32 with
  ``CF="PMIS"`` and ``filter_operator=(False, 0.1)``
  (``bench_suite.py:141-162``), ``solve_refined(tol=1e-10,
  accel="gmres", inner_maxiter=40, max_outer=20)``, b the gallery's rhs.

Each line holds the rows of the levels, the operator complexity, the
layout of each level's (A, P, R), the diagonals of each DIA level, the
(kind, t, passes, Sy) of each SELL operator, the outer count, the inner
iterations of each outer, the true relative residual in float64 and the
setup time by key.  ``--small`` runs RS 96^2 and AIR 64^2 instead.  It
runs with ``jax_enable_x64``, as the tests do, so that the PMIS keys
(in-degree plus a uniform draw) are float64 on both sides.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from jax_sell_reference import layouts, record_inner, sellify, use_interpret


def describe(ml):
    """Levels, complexity, layouts, DIA widths and SELL plans of ``ml``."""
    dia, plans = {}, {}
    for i, lvl in enumerate(ml.levels):
        for attr in "APR":
            op = getattr(lvl, attr, None)
            kind = type(op).__name__
            if kind == "DIA":
                dia[f"{attr}{i}"] = len(op.offsets)
            elif kind == "SELL":
                plans[f"{attr}{i}"] = [op.kind, op.t, op.n_passes, op.Sy]
    return {"rows": [int(l.A.shape[0]) for l in ml.levels],
            "operator_complexity": float(ml.operator_complexity()),
            "layouts": [list(t) for t in layouts(ml)], "dia": dia,
            "plans": plans}


def run(name, A64, b, build, **solve_kw):
    from pyamg_tpu.sparse.matrix import to_scipy
    S = to_scipy(A64)
    t0 = time.perf_counter()
    ml = build(A64.astype(jnp.float32))
    setup = time.perf_counter() - t0
    timings = {k: round(v, 3) for k, v in ml.setup_timings().items()}
    sellify(ml)
    out = {"config": name, **describe(ml)}
    inner = record_inner(ml)
    hist = []
    t0 = time.perf_counter()
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, residuals=hist, **solve_kw)
    out.update(outer=len(hist) - 1, inner=list(inner),
               true_relres=float(np.linalg.norm(b - S @ np.asarray(x)) /
                                 np.linalg.norm(b)),
               setup_s=setup, setup_by_key=timings,
               solve_s=time.perf_counter() - t0,
               device=jax.devices()[0].platform)
    return out


def rs_run(N):
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.classical import ruge_stuben_solver
    A64 = poisson((N, N))
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    return run(f"rs_poisson_{N}", A64, b, ruge_stuben_solver, accel="cg")


def air_run(N):
    from pyamg_tpu.gallery import advection_2d
    from pyamg_tpu.classical import air_solver
    A64, rhs = advection_2d((N, N))
    return run(f"air_advection_{N}", A64, np.asarray(rhs, np.float64),
               lambda A: air_solver(A, CF="PMIS",
                                    filter_operator=(False, 0.1)),
               accel="gmres", inner_maxiter=40, max_outer=20)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    # as the tests run it: the Luby keys (in-degree + a uniform draw) in
    # float64, as the port keeps them
    jax.config.update("jax_enable_x64", True)
    use_interpret()
    small = "--small" in sys.argv
    print(json.dumps(rs_run(96 if small else 500)), flush=True)
    print(json.dumps(air_run(64 if small else 256)), flush=True)
