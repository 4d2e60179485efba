"""The port's pairwise aggregation (``pairwise_aggregation`` and
``_one_matching`` in ``aggregation/aggregate.py``, and
``aggregation/pairwise.py``) against the JAX package's, on the CPU.

The matchings break ties with a draw from ``default_rng(seed)`` scaled by
1e-6 of the largest weight and added, in float64, to the float32 or
float64 ``-Re(a_ij)``, and take the first largest key: the labels must be
equal.  ``pairwise_solver``'s hierarchies of 2-D Poisson 24^2 (float32 and
float64) and its solves: rows and aggregates equal, A, P and R with equal
patterns and values within 1e-6 (float32) or 1e-12 (float64) of the
largest, operator complexity to 1e-12, the iteration counts equal.  The
JAX package's float64 hierarchy fed through ``hierarchy_from_arrays``
solves in its iteration count.
"""

import numpy as np
import pytest
import torch

from pyamg_tpu.aggregation import pairwise_solver as ref_pairwise_solver
from pyamg_tpu.aggregation.aggregate import \
    pairwise_aggregation as ref_pairwise
from pyamg_tpu.gallery import diffusion_stencil_2d as ref_stencil_2d
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.gallery import stencil_grid as ref_stencil_grid

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import pairwise_aggregation, pairwise_solver
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d, linear_elasticity,
                                     poisson, stencil_grid)

from test_torch_cycles import _coarse_spec, _ell, _smoother
from test_torch_rootnode import iterations, same_hierarchy

torch.set_num_threads(1)


def _operator(name, dtype):
    if name == "1d":
        return poisson((64,)), ref_poisson((64,))
    if name == "2d":
        A, Ar = poisson((16, 16)), ref_poisson((16, 16))
    else:
        st = diffusion_stencil_2d(epsilon=1e-2, theta=np.pi / 6, type="FE")
        A, Ar = stencil_grid(st, (16, 16)), ref_stencil_grid(
            ref_stencil_2d(epsilon=1e-2, theta=np.pi / 6, type="FE"),
            (16, 16))
    return A.astype(dtype), Ar.astype(dtype)


def _same_aggregation(got, want):
    (AggOp, Cpts), (RefAggOp, RefCpts) = got, want
    assert AggOp.shape == tuple(RefAggOp.shape)
    np.testing.assert_array_equal(AggOp.row_nnz, np.asarray(RefAggOp.row_nnz))
    has = np.asarray(RefAggOp.row_nnz) > 0
    np.testing.assert_array_equal(np.asarray(AggOp.cols)[has, 0],
                                  np.asarray(RefAggOp.cols)[has, 0])
    np.testing.assert_array_equal(AggOp.vals, np.asarray(RefAggOp.vals))
    np.testing.assert_array_equal(Cpts, np.asarray(RefCpts))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("matchings", [1, 2, 3])
@pytest.mark.parametrize("name", ["1d", "2d", "anisotropic"])
def test_pairwise_aggregation_matches_reference(name, matchings, dtype):
    A, Ar = _operator(name, dtype)
    _same_aggregation(pairwise_aggregation(A, matchings=matchings, seed=3),
                      ref_pairwise(Ar, matchings=matchings, seed=3))


def test_pairwise_aggregation_of_a_block_operator():
    """A BELL is matched on its blocks' minima."""
    A, _ = linear_elasticity((6, 6))
    Ar, _ = ref_elasticity((6, 6))
    _same_aggregation(pairwise_aggregation(A), ref_pairwise(Ar))


@pytest.fixture(scope="module")
def hierarchies():
    out = {}
    for dtype in (np.float32, np.float64):
        out[dtype] = (pairwise_solver(poisson((24, 24)).astype(dtype)),
                      ref_pairwise_solver(ref_poisson((24, 24)).astype(dtype)))
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_solver_matches_reference(hierarchies, dtype):
    ml, mr = hierarchies[dtype]
    assert len(ml.levels) >= 4
    same_hierarchy(ml, mr, tol=1e-6 if dtype == np.float32 else 1e-12)
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        np.testing.assert_array_equal(lp.AggOp.cols,
                                      np.asarray(lr.AggOp.cols))
        assert lp.pre[0] == lr.pre[0] == "gauss_seidel"
    got, want = iterations(ml, mr, "cg", tol=1e-5)
    assert got == want < 100


def test_reference_hierarchy_through_arrays(hierarchies):
    _, mr = hierarchies[np.float64]
    levels = []
    for i, lvl in enumerate(mr.levels):
        d = {"A": _ell(lvl.A)}
        if i < len(mr.levels) - 1:
            d.update(P=_ell(lvl.P), R=_ell(lvl.R), pre=_smoother(lvl.pre),
                     post=_smoother(lvl.post))
        levels.append(d)
    ml = hierarchy_from_arrays({"levels": levels,
                                "coarse": _coarse_spec(mr.coarse_solver)},
                               device="cpu")
    b = np.random.default_rng(0).standard_normal(mr.levels[0].A.shape[0])
    got, want = [], []
    ml.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=got)
    mr.solve(b, tol=1e-8, maxiter=100, accel="cg", residuals=want)
    assert len(got) == len(want) < 100
    assert np.abs(np.subtract(got, want)).max() <= 1e-12 * want[0]


def test_pairwise_solver_takes_only_pairwise():
    with pytest.raises(ValueError):
        pairwise_solver(poisson((8, 8)), aggregate="standard")
