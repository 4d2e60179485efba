"""One rank of the multi-process gloo runs of ``tests/test_torch_dist.py``.

    python tests/torch_dist_worker.py RANK WORLD PORT OUTDIR

joins a gloo group of WORLD processes at ``tcp://127.0.0.1:PORT`` (60 s
timeout), runs every flow of ``flows`` on its rank with the port alone
(no JAX: a spawned rank does not pay for it) and writes its results to
``OUTDIR/rank{RANK}.json``.  Not collected by pytest.
"""

import json
import os
import sys
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the dryrun's sizes: (n, max_coarse, replicate_below)
DRYRUN = (32, 8, 64)


def build(n, max_coarse):
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    A = poisson((n, n))
    return A, smoothed_aggregation_solver(A, max_coarse=max_coarse)


def sharded(n, max_coarse, replicate_below, mesh, spmv="gspmd"):
    from pyamg_tpu_torch.parallel import shard_hierarchy
    A, ml = build(n, max_coarse)
    return A, shard_hierarchy(ml, mesh, replicate_below=replicate_below,
                              spmv=spmv)


def solve(ml, b, **kw):
    """(residuals, x as a list) of ``ml.solve(b, **kw)``."""
    res = []
    x = ml.solve(b, residuals=res, **kw)
    return [float(v) for v in res], x.tolist()


def describe(ml):
    """Per level: what the collectives of one V-cycle follow from."""
    from pyamg_tpu_torch.parallel import HaloELL, ShardedELL
    from pyamg_tpu_torch.relaxation.relaxation import gs_order
    out = []
    for lvl in ml.levels:
        passes = []
        for kind, sopts, _ in (lvl.pre, lvl.post):
            if kind == "none":          # the coarsest level
                passes.append(0)
                continue
            assert kind == "gauss_seidel", kind
            passes.append(len(gs_order(sopts["ncolors"], sopts["sweep"],
                                       sopts["iterations"],
                                       sopts.get("omega", 1.0))))
        out.append({
            "A": type(lvl.A).__name__, "rows": int(lvl.A.shape[0]),
            "sharded": isinstance(lvl.A, (ShardedELL, HaloELL)),
            "offsets": list(getattr(lvl.A, "offsets", ())),
            "passes": passes,
            "P_in": getattr(lvl.P, "in_sharded", False),
            "R_in": getattr(lvl.R, "in_sharded", False)})
    return out


def cycle_counts(ml, rng_seed=5):
    """The collectives of one V-cycle from zero, by kind."""
    from pyamg_tpu_torch.parallel import partition
    A0 = ml.levels[0].A
    r = ml._scatter(np.random.default_rng(rng_seed).standard_normal(
        ml._fine_n), A0.dtype)
    M = ml.aspreconditioner()
    partition.reset_counts()
    M.matvec(r)
    return dict(partition.COUNTS)


def flows(mesh):
    from pyamg_tpu_torch.parallel import partition
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    out = {"rank": mesh.rank, "size": mesh.size}
    n, mc, rb = DRYRUN
    A, ml = sharded(n, mc, rb, mesh)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    out["levels_gspmd"] = describe(ml)
    partition.reset_counts()
    out["cg3"] = solve(ml, b, maxiter=3, tol=1e-12, accel="cg")
    out["cg3_counts"] = dict(partition.COUNTS)
    out["sa2"] = solve(ml, b, maxiter=2, tol=1e-12)
    out["cycle_gspmd"] = cycle_counts(ml)
    _, mlh = sharded(n, mc, rb, mesh, spmv="halo")
    out["levels_halo"] = describe(mlh)
    out["halo2"] = solve(mlh, b, maxiter=2, tol=1e-12)
    res, x = solve(mlh, b, maxiter=100, tol=1e-8, accel="cg")
    out["halo_cg"] = (res, x)
    out["halo_cg_relres"] = float(np.linalg.norm(b - to_scipy(A) @ x)
                                  / np.linalg.norm(b))
    out["cycle_halo"] = cycle_counts(mlh)
    # tests/test_halo.py's hierarchy solves (level 1 pads: 102 and 70
    # rows over 4 ranks)
    A, ml = sharded(24, 10, 64, mesh, spmv="halo")
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    out["halo24"] = solve(ml, b, maxiter=8, tol=1e-12)
    out["levels_halo24"] = describe(ml)
    A, ml = sharded(20, 10, 64, mesh, spmv="halo")
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    out["halo20cg"] = solve(ml, b, maxiter=30, tol=1e-10, accel="cg")
    # the same 20^2 CG on the gspmd path, and through GMRES
    A, ml = sharded(20, 10, 64, mesh)
    out["gspmd20cg"] = solve(ml, b, maxiter=30, tol=1e-10, accel="cg")
    out["gspmd20gmres"] = solve(ml, b, maxiter=30, tol=1e-10,
                                accel="gmres")
    return out


def main(argv):
    rank, world, port, outdir = int(argv[0]), int(argv[1]), int(argv[2]), \
        argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        from pyamg_tpu_torch.parallel import make_row_mesh
        out = flows(make_row_mesh(world, device="cpu"))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
