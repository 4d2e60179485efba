"""The port's remaining strength measures and aggregation methods against
the JAX package's, on the CPU: distance, energy-based, affinity and
algebraic-distance strength (directly and through ``strength_measure``),
greedy and parallel naive aggregation, parallel standard aggregation
(and the greedy form's graph without aggregates), and the
smoothed-aggregation routes they open with the Richardson and energy
prolongation smoothers, nonsymmetric SA and ``diagonal_dominance``.

Tolerances: the strength measures run the same numpy arithmetic (the
affinity and algebraic distances relax their test vectors by Jacobi,
whose update the JAX package orders the same way): equal patterns, values
within 1e-12 of the largest.  Aggregates and roots equal.  The SA
hierarchies: rows equal, A, P and R with equal patterns and values within
1e-10 of the largest (1e-12 for the Jacobi and Richardson routes),
operator complexity to 1e-12; the nonsymmetric R (energy on A^H) as in
``test_torch_rootnode``.
"""

import numpy as np
import pytest
import torch

from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.aggregation.aggregate import naive_aggregation as ref_naive
from pyamg_tpu.aggregation.aggregate import \
    standard_aggregation as ref_standard
from pyamg_tpu.gallery import advection_2d as ref_advection_2d
from pyamg_tpu.gallery import diffusion_stencil_2d as ref_stencil_2d
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.gallery import stencil_grid as ref_stencil_grid
from pyamg_tpu.strength import strength_measure as ref_strength
from pyamg_tpu.util.utils import \
    eliminate_diag_dom_nodes as ref_eliminate_diag_dom

from pyamg_tpu_torch import _native
from pyamg_tpu_torch.aggregation import (naive_aggregation,
                                         smoothed_aggregation_solver,
                                         standard_aggregation)
from pyamg_tpu_torch.aggregation.aggregate import aggregate_dispatch
from pyamg_tpu_torch.gallery import advection_2d, poisson
from pyamg_tpu_torch.sparse.matrix import ELL
from pyamg_tpu_torch.strength import strength_measure
from pyamg_tpu_torch.util.utils import eliminate_diag_dom_nodes

from test_torch_energy import port, same_operator
from test_torch_rootnode import same_hierarchy

torch.set_num_threads(1)


def _anisotropic(N=12):
    st = ref_stencil_2d(epsilon=1e-2, theta=np.pi / 6, type="FE")
    return ref_stencil_grid(st, (N, N))


def _coords(N=12):
    x, y = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return np.stack([x.ravel(), y.ravel() * 0.5], axis=1).astype(float)


MEASURES = [
    ("distance", {"V": _coords()}),
    ("distance", {"V": _coords(), "theta": 1.5, "relative_drop": False}),
    ("energy_based", {}), ("energy_based", {"theta": 0.05, "k": 3}),
    ("affinity", {}), ("affinity", {"R": 3, "k": 5, "epsilon": 2.0}),
    ("algebraic_distance", {}),
    ("algebraic_distance", {"p": np.inf, "R": 4, "k": 10}),
    ("algebraic_distance", {"p": 1, "alpha": 0.7, "seed": 3}),
]


@pytest.mark.parametrize("operator", ["poisson", "anisotropic", "block"])
@pytest.mark.parametrize("spec", MEASURES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(MEASURES)])
def test_strength_measure_matches_reference(spec, operator):
    name, opts = spec
    if operator == "poisson":
        A = ref_poisson((12, 12))
    elif operator == "anisotropic":
        A = _anisotropic()
    else:
        if name == "distance":
            opts = dict(opts, V=_coords(6))
        A, _ = ref_elasticity((6, 6))
    same_operator(strength_measure(port(A), (name, opts)),
                  ref_strength(A, (name, opts)), tol=1e-12)


def test_unported_options_raise():
    C = port(ref_strength(ref_poisson((6, 6)), ("symmetric", {})))
    # Lloyd, balanced Lloyd and METIS are ported; their unknown options
    # and an unknown method raise
    with pytest.raises(ValueError):
        aggregate_dispatch(C, "no such aggregation")
    with pytest.raises(ValueError):
        aggregate_dispatch(C, ("lloyd", {"distance": "max"}))
    with pytest.raises(ValueError):
        aggregate_dispatch(C, ("metis", {"measure": "max"}))
    with pytest.raises(ValueError):
        strength_measure(C, ("nearest", {}))
    with pytest.raises(ValueError):
        standard_aggregation(C, method="serial")


def _same_aggregates(got, want):
    (AggOp, roots), (RefAggOp, ref_roots) = got, want
    assert AggOp.shape == tuple(RefAggOp.shape)
    np.testing.assert_array_equal(AggOp.row_nnz, np.asarray(RefAggOp.row_nnz))
    np.testing.assert_array_equal(AggOp.cols, np.asarray(RefAggOp.cols))
    np.testing.assert_array_equal(roots, np.asarray(ref_roots))


STRENGTHS = {"poisson": lambda: ref_strength(ref_poisson((20, 20)),
                                            ("symmetric", {})),
             "anisotropic": lambda: ref_strength(_anisotropic(16),
                                                 ("symmetric",
                                                  {"theta": 0.1})),
             "1d": lambda: ref_strength(ref_poisson((50,)),
                                        ("classical", {}))}


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("method", ["naive-greedy", "naive-parallel",
                                    "standard-parallel"])
@pytest.mark.parametrize("graph", list(STRENGTHS))
def test_aggregation_matches_reference(graph, method, seed):
    C = STRENGTHS[graph]()
    kind, how = method.split("-")
    fn, ref_fn = ((naive_aggregation, ref_naive) if kind == "naive" else
                  (standard_aggregation, ref_standard))
    _same_aggregates(fn(port(C), seed=seed, method=how),
                     ref_fn(C, seed=seed, method=how))


def test_graph_without_aggregates_takes_the_parallel_form():
    """A strength graph of isolated nodes has no greedy aggregate: standard
    aggregation makes every node an aggregate, as the JAX package's
    parallel form does."""
    n = 9
    C = ELL(np.arange(n, dtype=np.int32)[:, None], np.ones((n, 1)),
            np.ones(n, np.int32), (n, n))
    from pyamg_tpu.sparse.matrix import ELL as RefELL
    Cr = RefELL(np.asarray(C.cols), np.asarray(C.vals),
                np.asarray(C.row_nnz), C.shape)
    _same_aggregates(standard_aggregation(C), ref_standard(Cr))
    assert standard_aggregation(C)[0].shape == (n, n)


def test_naive_aggregation_raises_without_its_native_library(monkeypatch):
    """No g++: the greedy aggregations raise; they do not fall back to the
    parallel forms (which would change the hierarchy)."""
    C = port(STRENGTHS["poisson"]())
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    _native._lib.cache_clear()
    try:
        for fn in (naive_aggregation, standard_aggregation):
            with pytest.raises(RuntimeError, match="g\\+\\+"):
                fn(C)
    finally:
        _native._lib.cache_clear()


def test_native_aggregation_library_is_keyed_by_its_source():
    """The aggregation library, with both greedy aggregations, is built
    from ``_native/aggregation.cpp`` under a name keyed by the hash of that
    source and its compiler command."""
    import hashlib
    import os
    lib = _native._lib("aggregation")
    assert hasattr(lib, "naive_aggregation") and \
        hasattr(lib, "standard_aggregation")
    src = os.path.join(os.path.dirname(_native.__file__), "aggregation.cpp")
    with open(src, "rb") as f:
        text = f.read()
    assert b"i32 naive_aggregation(" in text
    digest = hashlib.sha256(text)
    digest.update("\0".join([_native.shutil.which("g++"), "-O3", "-shared",
                             "-fPIC", "-std=c++17"]).encode())
    assert os.path.basename(lib._name) == \
        f"libaggregation-{digest.hexdigest()[:16]}.so"


def test_diagonal_dominance_elimination_matches_reference():
    A = ref_poisson((10, 10))
    S = ref_strength(A, ("symmetric", {}))
    for theta in (0.5, 1.02, 1.5):
        same_operator(eliminate_diag_dom_nodes(port(A), port(S), theta),
                      ref_eliminate_diag_dom(A, S, theta), tol=0)


# -- the smoothed-aggregation routes ------------------------------------------

def _dominant(N=16):
    """2-D Poisson with a band of strongly diagonally dominant rows."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
    S = to_scipy(poisson((N, N))).tolil()
    for i in range(0, N * N, 7):
        S[i, i] = 40.0
    return from_scipy(sp.csr_matrix(S))


SA_CASES = {
    "richardson": ({"smooth": ("richardson", {"omega": 1.0, "degree": 2})},
                   1e-12),
    "energy": ({"smooth": ("energy", {"krylov": "cgnr", "maxiter": 3})},
               1e-10),
    "energy-gmres": ({"smooth": ("energy", {"krylov": "gmres"})}, 1e-10),
    "naive": ({"aggregate": "naive"}, 1e-12),
    "naive-parallel": ({"aggregate": ("naive", {"method": "parallel"})},
                       1e-12),
    "standard-parallel": ({"aggregate": ("standard",
                                         {"method": "parallel"})}, 1e-12),
    "pairwise": ({"aggregate": ("pairwise", {"matchings": 2})}, 1e-12),
    "affinity": ({"strength": ("affinity", {"R": 4, "k": 6})}, 1e-12),
    "nonsymmetric": ({"symmetry": "nonsymmetric"}, 1e-12),
    "nonsymmetric-energy": ({"symmetry": "nonsymmetric", "smooth": "energy"},
                            1e-10),
    "diagonal-dominance": ({"diagonal_dominance": True}, 1e-12),
    "diagonal-dominance-theta": ({"diagonal_dominance": (True,
                                                         {"theta": 1.1})},
                                 1e-12),
}


@pytest.mark.parametrize("name", list(SA_CASES))
def test_sa_route_matches_reference(name):
    kw, tol = SA_CASES[name]
    if name.startswith("nonsymmetric"):
        A, Ar = advection_2d((16, 16))[0], ref_advection_2d((16, 16))[0]
    elif name.startswith("diagonal"):
        A = _dominant()
        from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
        from pyamg_tpu_torch.sparse.matrix import to_scipy
        Ar = ref_from_scipy(to_scipy(A))
    else:
        A, Ar = poisson((20, 20)), ref_poisson((20, 20))
    ml = smoothed_aggregation_solver(A, max_coarse=10, **kw)
    mr = ref_sa(Ar, max_coarse=10, **kw)
    # the dominant rows stay on the fine level: two levels there
    assert len(ml.levels) >= (2 if name.startswith("diagonal") else 3)
    same_hierarchy(ml, mr, tol=tol, strict=name != "nonsymmetric-energy")
    if name.startswith("nonsymmetric"):
        np.testing.assert_allclose(ml.levels[1].BH,
                                   np.asarray(mr.levels[1].BH), rtol=1e-10)
