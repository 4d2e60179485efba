"""The plain reference against the program on the CPU at tiny grids: the
same operator, the same hierarchies, the same iterations.  (The tests may
import the program; the reference itself may not.)"""

import numpy as np
import pytest
import torch

from amg_bench.reference import distsa, gridsa
from amg_bench.generators.rhs_pool import draw
from amg_bench.reference.poisson import poisson2d, true_relres


@pytest.mark.parametrize("n", [7, 24])
def test_operator_is_the_galleries(n):
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    assert (abs(poisson2d(n) - to_scipy(poisson((n, n)))).max() == 0)


@pytest.mark.parametrize("n", [20, 48, 97])
def test_grid_sa_hierarchy_is_the_programs(n):
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    ml = smoothed_aggregation_solver(poisson((n, n)).astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    got = {"levels": len(ml.levels),
           "rows": [l.A.shape[0] for l in ml.levels],
           "nnz": [int(l.A.nnz) for l in ml.levels]}
    assert got == gridsa.describe(gridsa.hierarchy(n))


def test_grid_sa_solve_takes_the_programs_iterations():
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    n, cut = 64, 600
    A64 = poisson((n, n))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=cut, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    ref = gridsa.Solver(gridsa.hierarchy(n), "cpu", torch.float64, cut)
    A = poisson2d(n)
    for seed in (1, 2 ** 31 + 5):
        b = draw(seed, 0, n * n)
        it = {}
        x = ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                    inner_maxiter=30, max_outer=10,
                                    iterations_out=it)
        xr, outer, inner = ref.solve(b, 1e-10, 1e-5, 30, 10)
        assert (it["outer"], abs(it["inner"] - inner)) == (outer, 0)
        assert true_relres(A, b, x) < 1e-10 and true_relres(A, b, xr) < 1e-10


def test_grid_coloring_is_valid():
    for lvl in gridsa.hierarchy(40):
        colors, _ = gridsa.grid_colors(lvl["m"], lvl["m"] != 40)
        assert gridsa.check_coloring(lvl["A"], colors)


def test_distributed_sa_hierarchy_and_iterations_are_the_programs():
    import torch.distributed as dist
    from pyamg_tpu_torch.parallel import (StackedMesh, dist_stencil_grid,
                                          distributed_sa_setup)
    n = 80
    mesh = StackedMesh(1, torch.device("cpu"))
    st = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
    cols, vals, ok, n_loc = dist_stencil_grid(st, (n, n), mesh,
                                              dtype=torch.float32)
    hier = distributed_sa_setup(cols, vals, ok, n_loc, mesh,
                                coarsen_until=1000)
    A = poisson2d(n)
    levels = distsa.hierarchy(A, 1000)
    want = distsa.describe(levels)
    assert len(hier.levels) == want["levels"] >= 3
    assert [L.n_loc for L in hier.levels] == want["rows"]
    assert hier.diagnostics["nagg"][0] == want["nagg"][0]
    ref = distsa.Solver(levels, "cpu", torch.float64)
    b = draw(9, 0, n * n)
    x, relres, it = hier.solve_cg(b, tol=1e-8, maxiter=40)
    xr, it_ref = ref.solve(b, 1e-8, 40)
    assert abs(int(it) - it_ref) <= 1
    assert true_relres(A, b, xr) < 1e-8
    assert true_relres(A, b, x.double().numpy()) < 1e-4
    assert not dist.is_initialized()
