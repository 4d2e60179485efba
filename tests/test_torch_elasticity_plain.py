"""2-D linear elasticity on the main path against the benchmark's plain
reference (``amg_bench/reference/elasticity.py``, NumPy, SciPy and torch
alone) at 12^2-40^2 on the CPU: the operator, the hierarchy's levels,
rows, block sizes and stored entries, the double-single outer residual
on a block operator, and ``solve_refined_device`` on the block
hierarchy; and the grid path's banded double-single residual, bit for
bit the JAX package's."""

import numpy as np
import pytest
import torch

from amg_bench.reference import elasticity as ref
from pyamg_tpu_torch import _graph
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.ops import ds
from pyamg_tpu_torch.sparse.matrix import bell_from_scipy, to_scipy

from torch_stand_in import stand_in_programs

torch.set_num_threads(1)


def _f32(v):
    return torch.as_tensor(v)


def _program(n, collapse=300):
    """The main path on the reference's operator: the hierarchy as the
    benchmark's system builds it, then its prep on the CPU."""
    A, B = ref.operator(n)
    A64 = bell_from_scipy(A)
    ml = smoothed_aggregation_solver(A64.astype(np.float32), B=B,
                                     max_coarse=50)
    desc = {"levels": len(ml.levels),
            "rows": [int(l.A.shape[0]) for l in ml.levels],
            "blocksize": [int(l.A.blocksize[0]) for l in ml.levels],
            "nnz": [int(l.A.nnz) for l in ml.levels]}
    ml.compress_stencils()
    ml.collapse_coarse(max_n=collapse, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    return ml, desc, A


@pytest.mark.parametrize("n", [12, 24, 40])
def test_gallery_is_the_references_assembly_with_two_corners_exchanged(n):
    """The port's gallery places an element's corners (1, 0) and (0, 1)
    the other way round from PyAMG's q12d (as the JAX package does); with
    those two exchanged, the reference's assembly gives its operator and
    candidates exactly."""
    A, B = linear_elasticity((n, n))
    S, Bs = ref.assemble(n, (0, n + 2, n + 3, 1))
    assert abs(to_scipy(A) - S).max() < 1e-9 * abs(S).max()
    assert np.array_equal(B, Bs)


@pytest.mark.parametrize("n", [12, 40])
def test_reference_candidates_span_the_free_operators_kernel(n):
    """PyAMG's operator: the rows of nodes two or more from the boundary
    see no Dirichlet cut, and there A B = 0 for all three rigid-body
    modes; the program is handed this operator as its block form."""
    A, B = ref.operator(n)
    i, j = np.divmod(np.arange(n * n), n)
    deep = (np.minimum(i, j) >= 1) & (np.maximum(i, j) <= n - 2)
    rows = np.stack([2 * np.flatnonzero(deep),
                     2 * np.flatnonzero(deep) + 1], axis=1).ravel()
    assert np.abs((A @ B)[rows]).max() < 1e-9 * abs(A).max()
    assert abs(to_scipy(bell_from_scipy(A)) - A).max() == 0


@pytest.mark.parametrize("n", [12, 24, 40])
def test_hierarchy_is_the_references(n):
    _, desc, _ = _program(n)
    assert desc == ref.describe(ref.hierarchy(n, max_coarse=50))


@pytest.mark.parametrize("n", [12, 40])
def test_bell_ds_residual_matches_f64(n):
    """b - A x in double-single on a BELL (its scalar rows as an ELL of
    18 slots a row, each stored block's entries) equals the float64
    residual to 1e-12 of ||b|| where the residual is 1e-9 of b."""
    A, _ = ref.operator(n)
    A64 = bell_from_scipy(A)
    rng = np.random.default_rng(8)
    xstar = rng.standard_normal(A.shape[0])
    b = A @ xstar
    x = xstar * (1.0 + 1e-9 * rng.standard_normal(A.shape[0]))
    r64 = b - A @ x
    A_ds = ds.ds_operator(A64, device="cpu")
    assert A_ds["kind"] == "ell" and A_ds["cols"].shape[1] == 18
    xhi, xlo = map(_f32, ds.ds_from_f64(x))
    bhi, blo = map(_f32, ds.ds_from_f64(b))
    got = ds.ds_to_f64(*ds.ds_residual(A_ds, xhi, xlo, bhi, blo))
    assert np.linalg.norm(got - r64) < 1e-12 * np.linalg.norm(b)
    assert abs(np.linalg.norm(got) - np.linalg.norm(r64)) \
        < 1e-6 * np.linalg.norm(r64)


@pytest.mark.parametrize("form", ["eager", "captured"])
def test_refined_device_solve_on_the_block_hierarchy(form):
    """``solve_refined_device`` on the BELL hierarchy reaches tol within
    the limits, op by op and captured (the CPU stand-in of the card's
    graphs), in the reference's own outer and inner iterations."""
    n, cut = 40, 300
    ml, _, A = _program(n, cut)
    solver = ref.Solver(ref.hierarchy(n, max_coarse=50), "cpu",
                        torch.float64, cut)
    b = np.random.default_rng(2 ** 31 + 3).standard_normal(A.shape[0])
    run = _graph.eager if form == "eager" else stand_in_programs
    with run():
        it, res = {}, []
        x = ml.solve_refined_device(b, tol=1e-10, inner_tol=1e-5,
                                    inner_maxiter=60, max_outer=20,
                                    residuals=res, iterations_out=it)
    _, outer, inner = solver.solve(b, 1e-10, 1e-5, 60, 20)
    assert (it["outer"], it["inner"]) == (outer, inner)
    assert res[-1] <= 1e-10 * res[0]
    assert ref.true_relres(A, b, x) < 1e-10


@pytest.mark.parametrize("n", [24, 64])
def test_grid_dia_ds_residual_is_the_jax_packages_bit_for_bit(n):
    """The grid path's outer residual (a banded operator) as the JAX
    package computes it, bit for bit: the block route added beside it
    leaves the banded one as it was."""
    import jax.numpy as jnp
    from pyamg_tpu.gallery import poisson as jax_poisson
    from pyamg_tpu.ops import ds as jax_ds
    A64 = poisson((n, n))
    S = to_scipy(A64)
    rng = np.random.default_rng(n)
    xstar = rng.standard_normal(S.shape[0])
    b = S @ xstar
    x = xstar * (1.0 + 1e-9 * rng.standard_normal(S.shape[0]))
    A_ds = ds.ds_operator(A64, device="cpu")
    assert A_ds["kind"] == "dia"
    got = ds.ds_residual(A_ds, *map(_f32, ds.ds_from_f64(x)),
                         *map(_f32, ds.ds_from_f64(b)))
    J = jax_ds.ds_operator(jax_poisson((n, n)))
    want = jax_ds.ds_residual(J, *map(jnp.asarray, jax_ds.ds_from_f64(x)),
                              *map(jnp.asarray, jax_ds.ds_from_f64(b)))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
