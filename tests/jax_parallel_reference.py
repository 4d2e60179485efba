"""The JAX package's row-sharded solves on the CPU: the numbers the port's
``parallel:`` phase of ``chip_smoke.py`` and ``tests/test_torch_dist.py``
are held to.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/jax_parallel_reference.py

runs the first three flows of ``__graft_entry__.dryrun_multichip`` on a
4-device row mesh (``make_row_mesh(4)`` over virtual CPU devices, with
``jax_enable_x64``): ``smoothed_aggregation_solver(poisson((N, N)),
max_coarse=...)`` in float64, ``shard_hierarchy(ml, mesh,
replicate_below=...)`` and ``b = default_rng(0).standard_normal(n)``, then

* ``cg3``: ``solve(b, maxiter=3, tol=1e-12, accel="cg")`` on the gspmd
  path (and ``cg3_unsharded`` on the same hierarchy left unsharded);
* ``sa2``: ``solve(b, maxiter=2, tol=1e-12)``, standalone, gspmd;
* ``halo2``: the same on a hierarchy sharded with ``spmv="halo"``;
* ``halo_cg``: CG on the halo hierarchy to ``tol=1e-8`` (``maxiter=100``):
  its iterations and true relative residual.

It prints one JSON line per size: the rows of the levels, the sharded
levels, each residual history and the halo CG's counts.  The full run is
32^2 (``max_coarse=8``, ``replicate_below=64``) and 500^2
(``max_coarse=10``, ``replicate_below=2048``; about a minute and 2 GB
here); ``--small`` runs 32^2 only.
"""

import json
import os
import sys

if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

SIZES = {32: dict(max_coarse=8, replicate_below=64),
         500: dict(max_coarse=10, replicate_below=2048)}
# (n, max_coarse, replicate_below) of the dryrun
DRYRUN_ARGS = (32, 8, 64)


def build(n, max_coarse):
    from pyamg_tpu.gallery import poisson
    from pyamg_tpu.aggregation import smoothed_aggregation_solver
    A = poisson((n, n))
    return A, smoothed_aggregation_solver(A, max_coarse=max_coarse)


def sharded(n, max_coarse, replicate_below, spmv="gspmd", ndev=4):
    """(A, ml) with ml sharded over a ``ndev``-device row mesh."""
    from pyamg_tpu.parallel import make_row_mesh, shard_hierarchy
    A, ml = build(n, max_coarse)
    shard_hierarchy(ml, make_row_mesh(ndev), replicate_below=replicate_below,
                    spmv=spmv)
    return A, ml


def is_sharded(op):
    from pyamg_tpu.parallel.halo import HaloELL
    if isinstance(op, HaloELL):
        return True
    s = getattr(getattr(op, "cols", None), "sharding", None)
    return s is not None and not s.is_fully_replicated


def flows(n, max_coarse, replicate_below, ndev=4, seed=0):
    """The dryrun's three flows and the halo CG at ``n``^2."""
    import jax.numpy as jnp
    from pyamg_tpu.sparse.matrix import to_scipy
    A, ml0 = build(n, max_coarse)
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    out = {"n": n, "rows": [int(l.A.shape[0]) for l in ml0.levels]}
    res = []
    ml0.solve(b, maxiter=3, tol=1e-12, accel="cg", residuals=res)
    out["cg3_unsharded"] = [float(v) for v in res]
    _, ml = sharded(n, max_coarse, replicate_below, ndev=ndev)
    out["sharded"] = [i for i, l in enumerate(ml.levels) if is_sharded(l.A)]
    out["padded_rows"] = [int(l.A.shape[0]) for l in ml.levels]
    bj = jnp.asarray(b)
    res = []
    ml.solve(bj, maxiter=3, tol=1e-12, accel="cg", residuals=res)
    out["cg3"] = [float(v) for v in res]
    res = []
    ml.solve(bj, maxiter=2, tol=1e-12, residuals=res)
    out["sa2"] = [float(v) for v in res]
    _, mlh = sharded(n, max_coarse, replicate_below, spmv="halo", ndev=ndev)
    res = []
    mlh.solve(bj, maxiter=2, tol=1e-12, residuals=res)
    out["halo2"] = [float(v) for v in res]
    res = []
    x = mlh.solve(bj, maxiter=100, tol=1e-8, accel="cg", residuals=res)
    S = to_scipy(A)
    out["halo_cg_iters"] = len(res) - 1
    out["halo_cg_relres"] = float(np.linalg.norm(
        b - S @ np.asarray(x)[:A.shape[0]]) / np.linalg.norm(b))
    return out


def halo_cases(ndev=4):
    """``tests/test_halo.py``'s two hierarchy solves on a ``ndev``-device
    mesh: (residuals, x) of the 24^2 standalone solve (``maxiter=8``) and
    of the 20^2 CG to 1e-10."""
    import jax.numpy as jnp
    out = {}
    A, ml = sharded(24, 10, 64, spmv="halo", ndev=ndev)
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    res = []
    x = ml.solve(jnp.asarray(b), maxiter=8, tol=1e-12, residuals=res)
    out["halo24"] = ([float(v) for v in res], np.asarray(x)[:A.shape[0]])
    A, ml = sharded(20, 10, 64, spmv="halo", ndev=ndev)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    res = []
    x = ml.solve(jnp.asarray(b), maxiter=30, tol=1e-10, accel="cg",
                 residuals=res)
    out["halo20cg"] = ([float(v) for v in res], np.asarray(x)[:A.shape[0]])
    return out


# the Krylov methods besides CG and GMRES, on a sharded hierarchy
KRYLOV = ("bicgstab", "cr", "minimal_residual", "steepest_descent",
          "gmres_mgs", "cgne", "cgnr", "gmres_householder")


def krylov_cases(ndev=4):
    """The residual history of ``solve(b, maxiter=3, tol=1e-12,
    accel=method)`` for each method of ``KRYLOV`` on the dryrun's 32^2
    hierarchy sharded over ``ndev`` devices (gspmd)."""
    import jax.numpy as jnp
    A, ml = sharded(*DRYRUN_ARGS, ndev=ndev)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(A.shape[0]))
    out = {}
    for method in KRYLOV:
        res = []
        ml.solve(b, maxiter=3, tol=1e-12, accel=method, residuals=res)
        out[method] = [float(v) for v in res]
    return out


def main(argv):
    sizes = [32] if "--small" in argv else [32, 500]
    for n in sizes:
        print(json.dumps(flows(n, **SIZES[n])), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
