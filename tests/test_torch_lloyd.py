"""The port's Lloyd, balanced Lloyd and METIS aggregation
(``aggregation/aggregate.py``) against the JAX package's, on the CPU.

Each aggregation of the symmetric strength of 2-D Poisson and of a
rotated anisotropic 2-D diffusion (16^2, or 10^2 for balanced Lloyd and
METIS), float64 and float32: AggOp and Cpts
equal (tolerance 0).  ``smoothed_aggregation_solver(aggregate='lloyd')``
on 2-D Poisson 24^2: rows, operator complexity to 1e-12, A, P and R with
equal patterns and values within 1e-10 of the largest (float64) or 1e-5
(float32), and the iteration counts of a solve equal.  ``'metis'`` without
pymetis is balanced Lloyd in both packages, and Lloyd's seeds do not
follow ``seed``, as in the JAX package.
"""

import sys

import numpy as np
import pytest
import torch

from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.aggregation import aggregate as ref_aggregate
from pyamg_tpu.gallery import diffusion_stencil_2d as ref_stencil_2d
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.gallery import stencil_grid as ref_stencil_grid
from pyamg_tpu.strength import symmetric_strength_of_connection as ref_soc

from pyamg_tpu_torch.aggregation import aggregate, smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import diffusion_stencil_2d, poisson, stencil_grid
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

from test_torch_rootnode import iterations, same_hierarchy

torch.set_num_threads(1)


def _strength(name, dtype, n=16):
    """(port's C, JAX package's C) of an n^2 grid."""
    if name == "poisson":
        A, Ar = poisson((n, n)), ref_poisson((n, n))
    else:
        A = stencil_grid(diffusion_stencil_2d(epsilon=1e-2, theta=np.pi / 6,
                                              type="FE"), (n, n))
        Ar = ref_stencil_grid(ref_stencil_2d(epsilon=1e-2, theta=np.pi / 6,
                                             type="FE"), (n, n))
    return (symmetric_strength_of_connection(A.astype(dtype), 0.1),
            ref_soc(Ar.astype(dtype), 0.1))


def _same_aggregation(got, want):
    (AggOp, Cpts), (RefAggOp, RefCpts) = got, want
    assert AggOp.shape == tuple(RefAggOp.shape)
    np.testing.assert_array_equal(AggOp.row_nnz, np.asarray(RefAggOp.row_nnz))
    has = np.asarray(RefAggOp.row_nnz) > 0
    np.testing.assert_array_equal(np.asarray(AggOp.cols)[has, 0],
                                  np.asarray(RefAggOp.cols)[has, 0])
    np.testing.assert_array_equal(AggOp.vals, np.asarray(RefAggOp.vals))
    assert AggOp.vals.dtype == np.asarray(RefAggOp.vals).dtype
    if RefCpts is None:
        assert Cpts is None
    else:
        np.testing.assert_array_equal(Cpts, np.asarray(RefCpts))


# Lloyd on 16^2 in both dtypes and on both matrices; balanced Lloyd and
# METIS, whose graph medians take a Floyd-Warshall per cluster, on 10^2
# (METIS's unit weights do not depend on the dtype)
LLOYD = [{"distance": "unit"}, {"distance": "abs"},
         {"distance": "inv", "ratio": 0.2, "maxiter": 3}]
CASES = [("lloyd", opts, 16, matrix, dtype) for opts in LLOYD
         for matrix in ("poisson", "anisotropic")
         for dtype in (np.float64, np.float32)] + [
    ("balanced lloyd", {"num_clusters": 12}, 10, "poisson", np.float64),
    ("balanced lloyd", {"num_clusters": 12}, 10, "anisotropic", np.float32),
    ("metis", {}, 10, "poisson", np.float64),
    ("metis", {"measure": "unit", "ratio": 0.15}, 10, "anisotropic",
     np.float64),
    ("metis", {"measure": "range", "ratio": 0.15}, 10, "anisotropic",
     np.float32),
    ("metis", {"measure": "range", "ratio": 0.15}, 10, "poisson",
     np.float64)]


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}-{np.dtype(c[4]).name}")
def test_aggregation_matches_reference(case, monkeypatch):
    monkeypatch.setitem(sys.modules, "pymetis", None)
    name, opts, n, matrix, dtype = case
    C, Cr = _strength(matrix, dtype, n)
    _same_aggregation(aggregate.aggregate_dispatch(C, (name, opts), seed=3),
                      ref_aggregate.aggregate_dispatch(Cr, (name, opts),
                                                       seed=3))


def test_lloyd_seeds_do_not_follow_seed():
    """``lloyd_cluster`` draws from ``default_rng(0)`` whatever ``seed``
    the caller gives, in both packages."""
    C, Cr = _strength("poisson", np.float64)
    got = aggregate.lloyd_aggregation(C, seed=7)
    _same_aggregation(got, aggregate.lloyd_aggregation(C, seed=0))
    _same_aggregation(got, ref_aggregate.lloyd_aggregation(Cr, seed=7))


def test_metis_without_pymetis_is_balanced_lloyd(monkeypatch):
    """With unit weights and as many parts, ``metis_aggregation`` is
    balanced Lloyd clustering's aggregation."""
    from pyamg_tpu_torch.graph import balanced_lloyd_cluster
    from pyamg_tpu_torch.sparse.matrix import ELL
    monkeypatch.setitem(sys.modules, "pymetis", None)
    C, _ = _strength("poisson", np.float64, 10)
    AggOp, Cpts = aggregate.metis_aggregation(C, ratio=0.15, seed=4)
    unit = ELL(C.cols, C.valid_mask().astype(np.float64), C.row_nnz, C.shape)
    labels, _ = balanced_lloyd_cluster(unit, int(0.15 * C.shape[0]), seed=4)
    np.testing.assert_array_equal(np.asarray(AggOp.cols)[:, 0], labels)
    assert Cpts is None


def test_an_unknown_distance_raises():
    C, _ = _strength("poisson", np.float64)
    with pytest.raises(ValueError):
        aggregate.lloyd_aggregation(C, distance="max")
    with pytest.raises(ValueError):
        aggregate.metis_aggregation(C, measure="max")


@pytest.fixture(scope="module")
def lloyd_hierarchies():
    out = {}
    for dtype in (np.float64, np.float32):
        kw = {"aggregate": ("lloyd", {}), "max_coarse": 5}
        out[dtype] = (
            smoothed_aggregation_solver(poisson((24, 24)).astype(dtype), **kw),
            ref_sa(ref_poisson((24, 24)).astype(dtype), **kw))
    return out


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lloyd_hierarchy_matches_reference(lloyd_hierarchies, dtype):
    ml, mr = lloyd_hierarchies[dtype]
    assert len(ml.levels) >= 3
    same_hierarchy(ml, mr, tol=1e-10 if dtype == np.float64 else 1e-5)
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        np.testing.assert_array_equal(lp.Cnodes, np.asarray(lr.Cnodes))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lloyd_solve_takes_the_reference_iterations(lloyd_hierarchies,
                                                     dtype):
    ml, mr = lloyd_hierarchies[dtype]
    tol = 1e-8 if dtype == np.float64 else 1e-5
    got, want = iterations(ml, mr, "cg", tol=tol)
    assert got == want
