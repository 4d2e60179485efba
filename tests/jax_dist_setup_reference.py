"""The JAX package's distributed setup on the CPU: the numbers that the
``parallel2:`` phase of ``chip_smoke.py`` holds the port to
(``chip_smoke.JAX_DIST``).

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_dist_setup_reference.py

runs, on virtual CPU devices (float32 operators, ``jax_enable_x64`` on so
that the true residual is float64):

* ``sa32`` / ``cl32``: the dryrun's two distributed flows at 32^2 on 8
  devices: ``distributed_sa_setup(coarsen_until=64)`` with
  ``solve_cg(tol=1e-5, maxiter=40)``, and
  ``distributed_classical_setup(coarsen_until=64)`` with
  ``solve_fgmres(tol=1e-5, restart=10, max_outer=6)``;
* ``sa1414`` / ``cheb1414``: ``distributed_sa_setup(coarsen_until=4096)``
  on 2-D Poisson 1414^2 over 8 devices (``bench_dist_scale.py``), Jacobi
  and Chebyshev, each with ``solve_cg(tol=1e-8, maxiter=40)``;
* ``sa1414r1``: the same SA on ``make_row_mesh(1)``;
* ``cl500``: ``distributed_classical_setup(coarsen_until=4096)`` on
  500^2 over 8 devices with ``solve_fgmres(tol=1e-5, restart=10,
  max_outer=6)``.

b is ``default_rng(0).standard_normal(n_pad)`` with the pad rows zeroed.
The power iterations start from ``hashed_start`` (a function of the seed
and the global row index, patched in for ``jax.random.normal`` during each
setup; the JAX package is not edited), which the port computes too, so
that both start from the same vector.  ``--random`` keeps
``jax.random.normal``.  Each flow prints one JSON line: levels, each
level's ``n_loc`` and widths (A, P, R), margins, aggregates, dropped
entries, ``omega``, operator complexity, iterations, relres, the true
relative residual (float64, scipy, the unpadded operator) and the setup
and solve seconds.  The whole run takes about 20 minutes and 4 GB here;
``--small`` runs the 32^2 flows only (seconds); ``--spread [N ...]``
runs the SA setup at N^2 (default 500) with ``seed`` 0, 1 and 2 and
``jax.random.normal`` (the spread of what depends on rho; about 4 minutes
a seed at 1414^2); ``--float64`` runs the named flows' setups in float64
(the spread that float32 rounding alone makes), e.g. ``--float64 cl500``.
"""

import contextlib
import json
import os
import sys
import time

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    # a shard of a 1414^2 level can keep the others waiting in a
    # collective for longer than XLA:CPU's default 40 s
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_cpu_collective_call_terminate_timeout_seconds=7200"
        " --xla_cpu_collective_timeout_seconds=7200").strip()

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

STENCIL = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)


def hashed_start(seed, rows):
    """The power iteration's start vector at global rows ``rows`` (int64):
    a hash of (seed, row) scaled to [-0.5, 0.5), exact in any integer
    arithmetic of 64 bits (``pyamg_tpu_torch.parallel.dist_setup.
    hashed_start`` computes the same)."""
    import jax.numpy as jnp
    h = ((rows + 1) * 2654435761 + (seed + 1) * 2246822519) & 0xFFFFFFFF
    return h.astype(jnp.float64) / 4294967296.0 - 0.5


@contextlib.contextmanager
def hashed_random():
    """``jax.random.PRNGKey``/``fold_in``/``normal`` replaced, for the
    ``with`` block, so that ``dist_setup._power_rho``'s draw
    ``normal(fold_in(PRNGKey(seed), dev), (n,), dtype)`` gives
    ``hashed_start(seed, dev * n + arange(n))``."""
    import jax.numpy as jnp
    import jax.random as jr
    saved = jr.PRNGKey, jr.fold_in, jr.normal

    def normal(key, shape, dtype):
        seed, dev = key
        rows = dev.astype(jnp.int64) * shape[0] + jnp.arange(
            shape[0], dtype=jnp.int64)
        return hashed_start(jnp.int64(seed), rows).astype(dtype)

    jr.PRNGKey = lambda seed: seed
    jr.fold_in = lambda key, data: (key, data)
    jr.normal = normal
    try:
        yield
    finally:
        jr.PRNGKey, jr.fold_in, jr.normal = saved


def grid(n, ndev, dtype):
    import jax.numpy as jnp
    from pyamg_tpu.parallel import dist_stencil_grid, make_row_mesh
    mesh = make_row_mesh(ndev)
    return mesh, dist_stencil_grid(STENCIL, (n, n), mesh,
                                   dtype=getattr(jnp, dtype))


def _tosp(cols, vals, ok, ncols):
    import scipy.sparse as sp
    c, v, o = (np.asarray(a) for a in (cols, vals, ok))
    rows = np.repeat(np.arange(c.shape[0]), c.shape[1])
    m = o.ravel()
    return sp.csr_matrix((v.ravel()[m].astype(np.float64),
                          (rows[m], c.ravel()[m])), shape=(c.shape[0], ncols))


def describe(hier):
    """The hierarchy's numbers: what the port's gates read."""
    levels = hier.levels
    return {
        "levels": len(levels),
        "n_loc": [int(L.n_loc) for L in levels],
        "W": [int(L.cols.shape[1]) for L in levels],
        "WP": [int(L.p_cols.shape[1]) for L in levels[:-1]],
        "WR": [int(L.r_cols.shape[1]) for L in levels[:-1]],
        "margins": [int(g) for g in hier.diagnostics["margins"]],
        "nagg": [int(a) for a in hier.diagnostics["nagg"]],
        "dropped": [int(d) for d in hier.diagnostics["dropped"]],
        "omega": [float(L.omega) for L in levels],
        "nnz": [int(L.nnz()) for L in levels],
        "operator_complexity": float(hier.operator_complexity()),
        "coarse_n": int(hier.coarse_n)}


def flow(name, n, ndev, setup, solve, dtype="float32", hashed=True,
         seed=0, **kw):
    """One flow: setup and solve, with the numbers of ``describe``."""
    import jax.numpy as jnp
    from pyamg_tpu.parallel import (distributed_classical_setup,
                                    distributed_sa_setup)
    mesh, (cols, vals, ok, n_loc) = grid(n, ndev, dtype)
    fn = distributed_sa_setup if setup == "sa" else \
        distributed_classical_setup
    t0 = time.perf_counter()
    with hashed_random() if hashed else contextlib.nullcontext():
        hier = fn(cols, vals, ok, n_loc, mesh, seed=seed, **kw)
    t_setup = time.perf_counter() - t0
    out = {"flow": name, "n": n, "ndev": ndev, "setup": setup,
           "hashed": hashed, "seed": seed}
    out.update(describe(hier))
    out["setup_s"] = t_setup
    if solve is None:
        return out
    nn = n * n
    b = np.random.default_rng(0).standard_normal(cols.shape[0])
    b[nn:] = 0.0
    t0 = time.perf_counter()
    if solve == "cg":
        x, relres, it = hier.solve_cg(jnp.asarray(b, getattr(jnp, dtype)),
                                      **SOLVE[name])
    else:
        x, relres, it = hier.solve_fgmres(
            jnp.asarray(b, getattr(jnp, dtype)), **SOLVE[name])
    out["solve_s"] = time.perf_counter() - t0
    L0 = hier.levels[0]
    S = _tosp(L0.cols, L0.vals, L0.ok, L0.n)[:nn, :nn]
    xs = np.asarray(x, np.float64)[:nn]
    out.update(iterations=int(it), relres=float(relres),
               true_relres=float(np.linalg.norm(b[:nn] - S @ xs)
                                 / np.linalg.norm(b[:nn])))
    return out


SOLVE = {"sa32": dict(tol=1e-5, maxiter=40),
         "cl32": dict(tol=1e-5, restart=10, max_outer=6),
         "sa1414": dict(tol=1e-8, maxiter=40),
         "cheb1414": dict(tol=1e-8, maxiter=40),
         "sa1414r1": dict(tol=1e-8, maxiter=40),
         "cl500": dict(tol=1e-5, restart=10, max_outer=6)}

FLOWS = {
    "sa32": dict(n=32, ndev=8, setup="sa", solve="cg", coarsen_until=64),
    "cl32": dict(n=32, ndev=8, setup="classical", solve="fgmres",
                 coarsen_until=64),
    "sa1414": dict(n=1414, ndev=8, setup="sa", solve="cg",
                   coarsen_until=4096),
    "cheb1414": dict(n=1414, ndev=8, setup="sa", solve="cg",
                     coarsen_until=4096, smoother="chebyshev"),
    "sa1414r1": dict(n=1414, ndev=1, setup="sa", solve="cg",
                     coarsen_until=4096),
    "cl500": dict(n=500, ndev=8, setup="classical", solve="fgmres",
                  coarsen_until=4096)}


def main(argv):
    hashed = "--random" not in argv
    if "--spread" in argv:
        sizes = [int(a) for a in argv if a.isdigit()] or [500]
        for n in sizes:
            for seed in (0, 1, 2):
                print(json.dumps(flow(f"sa{n}s{seed}", n, 8, "sa", None,
                                      hashed=False, seed=seed,
                                      coarsen_until=4096)), flush=True)
        return
    names = ["sa32", "cl32"] if "--small" in argv else list(FLOWS)
    only = [a for a in argv if a in FLOWS]
    for name in only or names:
        kw = dict(FLOWS[name])
        if "--float64" in argv:
            kw.update(dtype="float64", solve=None)
        print(json.dumps(flow(name, hashed=hashed, **kw)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
