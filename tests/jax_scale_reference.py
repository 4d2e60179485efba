"""The JAX package's 10M-unknown single-chip flows on the CPU: the numbers
the port's ``scale:`` phase of ``chip_smoke.py`` and
``tests/test_torch_scale.py`` are held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_scale_reference.py

runs, in the JAX package, the flow of ``benchmarks/bench_10m_solve.py`` on
2-D Poisson 3163^2 (10,004,569 unknowns): grid SA of the float32 copy
(``max_coarse=10``), ``compress_stencils()``, ``collapse_coarse(4096)``,
``enable_ds_refinement(A64)``, then ``solve_refined_device(b, tol=1e-10,
inner_tol=1e-5, inner_maxiter=40, max_outer=10)`` with b from
``default_rng(2022)``; and the plan of ``benchmarks/bench_sell_scale.py``,
``sell_from_ell(A, k_choices=(4,))`` of the same float32 operator.  It
prints one JSON line each: the rows of the levels before and after the
collapse, the operator complexity, each level's (A, P, R) layout, the
diagonals of each DIA level, the outer and total inner iterations, the
true relative residual in float64 and the seconds of each part; the
plan's stored entries, passes, K, Sy, padded x rows and window bases.

At 3163^2 this is a full-size run: several GB and minutes of a CPU, so
it belongs on a host with the memory to spare, not beside other work.
``--small`` runs the sizes ``tests/test_torch_scale.py`` uses: the flow
at 49^2 and 193^2 and the plan at 1228^2, the smallest 2-D Poisson
whose plan is in the K4 regime (about 15 s).  It runs with
``jax_enable_x64``, as the tests do.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from jax_sell_reference import layouts


def describe(ml):
    """Rows, layouts and the diagonals of each DIA level of ``ml`` (either
    package's hierarchy)."""
    return {"rows": [int(lvl.A.shape[0]) for lvl in ml.levels],
            "layouts": [tuple(t) for t in layouts(ml)],
            "dia": {f"A{i}": len(lvl.A.offsets)
                    for i, lvl in enumerate(ml.levels)
                    if type(lvl.A).__name__ == "DIA"}}


def flow(N, keep=False):
    """The main path of ``bench_10m_solve.py`` at N^2; with ``keep`` the
    hierarchy, b and x too."""
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    t0 = time.perf_counter()
    A64 = poisson((N, N))
    t1 = time.perf_counter()
    ml = smoothed_aggregation_solver(A64.astype(jnp.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    t2 = time.perf_counter()
    before = [int(lvl.A.shape[0]) for lvl in ml.levels]
    oc = float(ml.operator_complexity())
    ml.compress_stencils()
    ml.collapse_coarse(max_n=4096)
    ml.enable_ds_refinement(A64)
    t3 = time.perf_counter()
    b = np.random.default_rng(2022).standard_normal(A64.shape[0])
    it = {}
    x = np.asarray(ml.solve_refined_device(
        b, tol=1e-10, inner_tol=1e-5, inner_maxiter=40, max_outer=10,
        iterations_out=it))
    t4 = time.perf_counter()
    out = {"N": N, "levels": len(before), "rows_before": before,
           "operator_complexity": oc, **describe(ml),
           "outer": int(it["outer"]), "inner": int(it["inner"]),
           "true_relres": float(np.linalg.norm(b - to_scipy(A64) @ x) /
                                np.linalg.norm(b)),
           "matrix_s": t1 - t0, "setup_s": t2 - t1, "prep_s": t3 - t2,
           "solve_s": t4 - t3, "device": jax.devices()[0].platform}
    if keep:
        out.update(ml=ml, b=b, x=x)
    return out


def plan(N):
    """The ``k_choices=(4,)`` SELL plan of 2-D Poisson N^2 (float32)."""
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.sparse.sell import sell_from_ell
    t0 = time.perf_counter()
    S = sell_from_ell(poisson((N, N)).astype(jnp.float32), k_choices=(4,))
    return {"N": N, "nnz": S.nnz, "passes": S.n_passes, "K": S.K,
            "Sy": S.Sy, "x_rows": S.x_rows, "base_lo": S.base_lo,
            "base_hi": S.base_hi, "plan_s": time.perf_counter() - t0}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    small = "--small" in sys.argv
    for N in (49, 193) if small else (3163,):
        print(json.dumps(flow(N)), flush=True)
    print(json.dumps(plan(1228 if small else 3163)), flush=True)
