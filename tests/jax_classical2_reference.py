"""The JAX package's block and complex classical paths on the CPU: the
numbers the port's ``classical2:`` phase of ``chip_smoke.py`` is held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_classical2_reference.py

builds three hierarchies in the JAX package, uncompressed (BELL and ELL
levels), and prints one JSON line each:

* BAIR: block AIR, ``air_solver(A, max_coarse=20,
  postsmoother="block_jacobi")`` on 2-D linear elasticity 100^2 (BSR 2 x 2,
  20,000 unknowns, float64).  The default post-smoother, ``fc_jacobi``,
  fails on the JAX package's block levels (it is handed the node-level
  C/F points against twice as many unknowns), so the reference solve
  takes block Jacobi;
* CRS: ``ruge_stuben_solver(A, max_coarse=10)`` and CAIR: ``air_solver(A,
  max_coarse=20)`` on ``poisson((256, 256)) * (1 + 0.5j)`` in complex128.

Each is solved by ``solve(b, tol=1e-8, accel="gmres")`` (b from
``default_rng(0)``; GMRES stops on the left-preconditioned residual).
Each line holds the rows and blocksizes of the levels, the operator
complexity, the layout of each level's (A, P, R), the iterations, the
preconditioned relative residual GMRES stopped on, the true relative
residual (scipy), and the setup and solve seconds.  ``--small`` runs
elasticity 24^2 and Poisson 32^2 instead (about 5 s).  It runs with
``jax_enable_x64``, as the tests do.
"""

import json
import sys
import time
import warnings

import numpy as np
import jax
import jax.numpy as jnp


def describe(ml):
    """Rows, blocksizes, operator complexity and layouts of ``ml``."""
    return {"rows": [int(lvl.A.shape[0]) for lvl in ml.levels],
            "blocksizes": [list(getattr(lvl.A, "blocksize", (1, 1)))
                           for lvl in ml.levels],
            "operator_complexity": float(ml.operator_complexity()),
            "layouts": [[type(getattr(lvl, a, None)).__name__ for a in "APR"]
                        for lvl in ml.levels]}


def run(name, A, S, b, build):
    """Build with ``build(A)``, solve by GMRES to 1e-8, describe."""
    t0 = time.perf_counter()
    ml = build(A)
    setup = time.perf_counter() - t0
    res = []
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x = ml.solve(jnp.asarray(b), tol=1e-8, accel="gmres", residuals=res)
    x = np.asarray(x)
    return {"config": name, **describe(ml), "iterations": len(res) - 1,
            "precond_relres": float(res[-1] / res[0]),
            "true_relres": float(np.linalg.norm(b - S @ x) /
                                 np.linalg.norm(b)),
            "setup_s": setup, "solve_s": time.perf_counter() - t0}


def paths(n_el=100, n_c=256):
    from pyamg_tpu.classical import air_solver, ruge_stuben_solver
    from pyamg_tpu.gallery import linear_elasticity, poisson
    from pyamg_tpu.sparse.matrix import to_scipy
    A_el, _ = linear_elasticity((n_el, n_el), format="bsr")
    b_el = np.random.default_rng(0).standard_normal(A_el.shape[0])
    yield run("BAIR", A_el, A_el.tocsr(), b_el,
              lambda A: air_solver(A, max_coarse=20,
                                   postsmoother="block_jacobi"))
    S = to_scipy(poisson((n_c, n_c))).tocsr().astype(np.complex128) * \
        (1 + 0.5j)
    b = np.random.default_rng(0).standard_normal(S.shape[0]).astype(
        np.complex128)
    yield run("CRS", S, S, b, lambda A: ruge_stuben_solver(A, max_coarse=10))
    yield run("CAIR", S, S, b, lambda A: air_solver(A, max_coarse=20))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    small = "--small" in sys.argv
    for line in paths(24 if small else 100, 32 if small else 256):
        print(json.dumps(line), flush=True)
