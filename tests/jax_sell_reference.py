"""The JAX package's SELL path on the CPU: the reference of the port's SELL
tests, and a script for its 3-D Poisson iteration counts.

On the CPU ``pallas_available()`` is False, so the JAX package's
``compress_stencils`` builds no SELL and its SELL kernels never run.
``sellify`` builds the SELL levels by the rule ``compress_stencils``
follows on a TPU (``sell_from_ell`` wherever ``dia_from_ell`` and
``phase_stencil_from_ell`` declined), and ``use_interpret`` routes
``sell_spmv`` and ``sell_gs_sweep`` to their Pallas kernels in interpret
mode.  ``SELL.mv`` and ``gauss_seidel`` look both names up at call time,
so the patch reaches them; the JAX package itself is not changed.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/jax_sell_reference.py 64

runs the 3-D Poisson N^3 flow of ``bench_suite.bench_sa_poisson_3d_64``
(standard SA, ``max_coarse=50``, ``solve_refined(tol=1e-10,
accel="cg")``, b from ``default_rng(0)``) and prints one JSON line: the
layouts, the outer count, the inner CG iterations of each outer and the
true relative residual.
"""

import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

import pyamg_tpu.ops.sell_kernels as sk
from pyamg_tpu.sparse.matrix import ELL
from pyamg_tpu.sparse.sell import sell_from_ell

_SPMV, _GS = sk.sell_spmv, sk.sell_gs_sweep


def spmv_interpret(A, x, interpret=False):
    return _SPMV(A, x, True)


def gs_interpret(A, x, b, Dinv, omega=1.0, sweep="forward", interpret=False):
    # the full positional signature: the symmetric branch of the original
    # passes ``interpret`` positionally
    return _GS(A, x, b, Dinv, omega, sweep, True)


def use_interpret(setattr_=setattr):
    """Route the JAX package's SELL kernels to interpret mode
    (``setattr_``: ``monkeypatch.setattr`` in a test)."""
    setattr_(sk, "sell_spmv", spmv_interpret)
    setattr_(sk, "sell_gs_sweep", gs_interpret)


def sellify(ml):
    """``ml.compress_stencils()`` as it runs where Pallas is available."""
    ml.compress_stencils()
    for lvl in ml.levels:
        if isinstance(lvl.A, ELL):
            S = sell_from_ell(lvl.A)
            if S is not None:
                lvl.A_ell, lvl.A = lvl.A, S
        for attr in ("P", "R"):
            op = getattr(lvl, attr, None)
            if isinstance(op, ELL):
                S = sell_from_ell(op)
                if S is not None:
                    setattr(lvl, attr + "_ell", op)
                    setattr(lvl, attr, S)
    ml._cycle_cache.clear()
    return ml


def layouts(ml):
    """[(kind of A, kind of P, kind of R), ...] of the levels."""
    return [tuple(type(getattr(l, a, None)).__name__ for a in "APR")
            for l in ml.levels]


def dia_orders(ml, setattr_):
    """{level: (pre order, post order)} of the DIA levels: the color-pass
    sequences the JAX package sweeps, recorded where ``gauss_seidel``
    hands them to the fused DIA sweep (made to decline, so the trace goes
    on through the jnp loop).  ``setattr_`` patches for the caller's
    scope (``monkeypatch.setattr``)."""
    import pyamg_tpu.ops.pallas_kernels as pk
    from pyamg_tpu.relaxation.smoothing import apply_smoother
    from pyamg_tpu.sparse.matrix import DIA
    seen = []
    setattr_(pk, "pallas_available", lambda: True)
    setattr_(pk, "dia_spmv_pallas", lambda A, x: None)
    setattr_(pk, "dia_gs_sweep", lambda *a, **k: seen.append(list(a[5])))
    orders = {}
    for i, lvl in enumerate(ml.levels[:-1]):
        if not isinstance(lvl.A, DIA):
            continue
        sds = jax.ShapeDtypeStruct((lvl.A.shape[0],), jnp.float32)
        pair = []
        for kind, sopts, params in (lvl.pre, lvl.post):
            jax.eval_shape(lambda x, b: apply_smoother(
                kind, sopts, params, lvl.A, x, b), sds, sds)
            pair.append(seen.pop())
        orders[i] = pair
    return orders


def record_inner(ml):
    """Make ``ml.solve`` append its iteration count to the returned list."""
    counts = []
    solve = ml.solve

    def counted(b, **kw):
        res = []
        x = solve(b, residuals=res, **kw)
        counts.append(len(res) - 1)
        return x

    ml.solve = counted
    return counts


def poisson3d_run(N):
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    from pyamg_tpu.sparse.matrix import to_scipy
    use_interpret()
    A64 = poisson((N, N, N))
    S = to_scipy(A64)
    t0 = time.perf_counter()
    ml = sellify(smoothed_aggregation_solver(A64.astype(jnp.float32),
                                             max_coarse=50))
    setup = time.perf_counter() - t0
    inner = record_inner(ml)
    b = np.random.default_rng(0).standard_normal(A64.shape[0])
    hist = []
    t0 = time.perf_counter()
    x = ml.solve_refined(b, A_fine=S, tol=1e-10, accel="cg", residuals=hist)
    return {"N": N, "levels": len(ml.levels),
            "operator_complexity": ml.operator_complexity(),
            "layouts": layouts(ml), "outer": len(hist) - 1, "inner": inner,
            "true_relres": float(np.linalg.norm(b - S @ x) /
                                 np.linalg.norm(b)),
            "setup_s": setup, "solve_s": time.perf_counter() - t0,
            "device": jax.devices()[0].platform}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps(poisson3d_run(int(sys.argv[1]) if len(sys.argv) > 1
                                   else 64)))
