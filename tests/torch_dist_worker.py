"""One rank of the multi-process gloo runs of ``tests/test_torch_dist.py``.

    python tests/torch_dist_worker.py RANK WORLD PORT OUTDIR

joins a gloo group of WORLD processes at ``tcp://127.0.0.1:PORT`` (60 s
timeout), runs every flow of ``flows``, ``stand_in_flows`` and
``dist_setup_flows`` on its rank with the port alone (no JAX: a spawned
rank does not pay for it; the stand-in of a captured program,
``torch_stand_in.py``, imports only the port too) and
writes its results to ``OUTDIR/rank{RANK}.json`` and the distributed
setup's level arrays to ``OUTDIR/rank{RANK}_levels.npz``.  Not collected
by pytest.
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


def stand_in_flows(mesh):
    """The gspmd path's 20^2 CG and GMRES (``flows``) run as captured
    programs (``torch_stand_in.stand_in_programs``: each step recorded
    with its host reads refused, the loops run as a device would), twice,
    against the same solves op by op: {"stand_in_<accel>": {"equal": bit
    for bit in both runs, "graphs": recorded}}."""
    from pyamg_tpu_torch import _graph
    from torch_stand_in import stand_in_programs
    A, ml = sharded(20, 10, 64, mesh)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    out = {}
    for accel in ("cg", "gmres"):
        kw = dict(maxiter=30, tol=1e-10, accel=accel)
        with _graph.eager():
            want = solve(ml, b, **kw)
        with stand_in_programs():
            got = [solve(ml, b, **kw) for _ in range(2)]
        out[f"stand_in_{accel}"] = {"equal": all(g == want for g in got),
                                    "graphs": ml._graphs().captured()[0]}
    return out


# the Krylov methods besides CG and GMRES (jax_parallel_reference.KRYLOV)
KRYLOV = ("bicgstab", "cr", "minimal_residual", "steepest_descent",
          "gmres_mgs", "cgne", "cgnr", "gmres_householder")

# the distributed setups held across the two forms of the mesh:
# (name, kind, n, coarsen_until, solve)
DIST_SETUPS = (("sa96", "sa", 96, 300, "cg"),
               ("cheb40", "chebyshev", 40, 64, "cg"),
               ("cl40", "classical", 40, 64, "fgmres"))

LEVEL_FIELDS = ("cols", "vals", "ok", "Dinv", "p_cols", "p_vals", "p_ok",
                "r_cols", "r_vals", "r_ok", "cheb")

STENCIL = ((0, -1, 0), (-1, 4, -1), (0, -1, 0))


def krylov_flows(mesh):
    """Each method of ``KRYLOV`` for 3 iterations on the dryrun's 32^2
    hierarchy, on the gspmd and the halo path."""
    out = {}
    n, mc, rb = DRYRUN
    for spmv in ("gspmd", "halo"):
        A, ml = sharded(n, mc, rb, mesh, spmv=spmv)
        b = np.random.default_rng(0).standard_normal(A.shape[0])
        for method in KRYLOV:
            out[f"{spmv}_{method}"] = solve(ml, b, maxiter=3, tol=1e-12,
                                            accel=method)
    return out


def dist_setup(name, kind, n, coarsen_until, solve_kind, mesh):
    """(hierarchy, (x, relres, iterations)) of one of ``DIST_SETUPS`` on
    ``mesh`` (a RowMesh or a StackedMesh): float64, default start
    vectors, b = default_rng(3) with the pad rows zeroed."""
    import torch
    from pyamg_tpu_torch.parallel import (dist_stencil_grid,
                                          distributed_classical_setup,
                                          distributed_sa_setup)
    cols, vals, ok, n_loc = dist_stencil_grid(np.asarray(STENCIL), (n, n),
                                              mesh, dtype=torch.float64)
    if kind == "classical":
        hier = distributed_classical_setup(cols, vals, ok, n_loc, mesh,
                                           coarsen_until=coarsen_until)
    else:
        hier = distributed_sa_setup(
            cols, vals, ok, n_loc, mesh, coarsen_until=coarsen_until,
            smoother="chebyshev" if kind == "chebyshev" else "jacobi")
    b = np.random.default_rng(3).standard_normal(n_loc * mesh.size)
    b[n * n:] = 0.0
    if solve_kind == "cg":
        res = hier.solve_cg(b, tol=1e-8, maxiter=40)
    else:
        res = hier.solve_fgmres(b, tol=1e-8, restart=10, max_outer=4)
    return hier, res


def level_arrays(name, hier):
    """Every array of every level of ``hier``, keyed ``name/l/field``."""
    out = {}
    for i, L in enumerate(hier.levels):
        for f in LEVEL_FIELDS:
            a = getattr(L, f)
            if a is not None:
                out[f"{name}/{i}/{f}"] = a.cpu().numpy()
    out[f"{name}/coarse_dense"] = hier.coarse_dense.cpu().numpy()
    return out


def dist_setup_flows(mesh):
    """(JSON results, level arrays) of ``DIST_SETUPS`` on this rank."""
    out, arrays = {}, {}
    for name, kind, n, cu, sk in DIST_SETUPS:
        hier, (x, relres, it) = dist_setup(name, kind, n, cu, sk, mesh)
        out[name] = {"relres": relres, "iterations": it,
                     "diagnostics": {k: hier.diagnostics[k] for k in
                                     ("margins", "nagg", "dropped")},
                     "omega": [L.omega for L in hier.levels],
                     "oc": hier.operator_complexity()}
        arrays.update(level_arrays(name, hier))
        arrays[f"{name}/x"] = x.cpu().numpy()
    return out, arrays


def main(argv):
    rank, world, port, outdir = int(argv[0]), int(argv[1]), int(argv[2]), \
        argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        from pyamg_tpu_torch.parallel import make_row_mesh
        mesh = make_row_mesh(world, device="cpu")
        out = flows(mesh)
        out.update(krylov_flows(mesh))
        out.update(stand_in_flows(mesh))
        out["dist_setup"], arrays = dist_setup_flows(mesh)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(outdir, f"rank{rank}_levels.npz"), **arrays)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
