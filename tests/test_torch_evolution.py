"""The port's rotated anisotropic diffusion path against the JAX package's,
on the CPU: ``gallery/diffusion.py``, the evolution strength of
connection (``strength_evolution.py``) by each of its three routes, the
``'evolution'`` spec of ``strength_measure``, and the whole grid-SA
hierarchy of BASELINE config 3 at 64^2 with its ``solve_refined``.

Tolerances: the stencils are equal; each route of the evolution measure
runs the same numpy arithmetic in the same order on both sides, so its
pattern must be equal and its values within 1e-6 relative in float32 and
1e-12 in float64 of the largest (they come out equal).  Where the port
repairs the reference (a band wider than half the operator, squared, which
the reference's band route cannot slice), the port's band route is held
to the reference's general route within the same tolerances.  The
hierarchy: rows and layouts equal, operator complexity to 1e-12; the solve:
the JAX package's outer count exactly, each inner count within 1, and a
true relative residual below 1e-10.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.strength_evolution as ref_evolution
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import diffusion_stencil_2d as ref_stencil_2d
from pyamg_tpu.gallery import diffusion_stencil_3d as ref_stencil_3d
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import stencil_grid as ref_stencil_grid
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy
from pyamg_tpu.strength import strength_measure as ref_strength_measure

import pyamg_tpu_torch.strength_evolution as evolution
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import (diffusion_stencil_2d,
                                     diffusion_stencil_3d,
                                     linear_elasticity, stencil_grid)
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
from pyamg_tpu_torch.strength import strength_measure

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _anisotropic(N, dtype=np.float64, epsilon=1e-3, theta=np.pi / 8):
    """(port A, JAX A) of the rotated anisotropic FE operator on N^2."""
    st = diffusion_stencil_2d(epsilon=epsilon, theta=theta, type="FE")
    return (stencil_grid(st, (N, N)).astype(dtype),
            ref_stencil_grid(st, (N, N)).astype(dtype))


def _wide(N=24, dtype=np.float64):
    """A scalar operator of the anisotropic stencil with a symmetric pair
    of couplings reaching past half the rows (no longer a grid band)."""
    A, _ = _anisotropic(N, dtype)
    S = to_scipy(A).tolil()
    S[0, N * N // 2 + 12] = S[N * N // 2 + 12, 0] = -1e-3
    S = sp.csr_matrix(S)
    return from_scipy(S), ref_from_scipy(S)


def _unbanded(N=20, dtype=np.float64, seed=5):
    """An SPD-ish operator without a band: the anisotropic operator plus
    random symmetric couplings."""
    A, _ = _anisotropic(N, dtype)
    rng = np.random.default_rng(seed)
    R = sp.random(N * N, N * N, density=2.0 / (N * N), random_state=rng)
    R = -1e-2 * abs(R + R.T)
    S = sp.csr_matrix(to_scipy(A) + R + sp.diags(np.ravel(-R.sum(axis=1))))
    S = S.astype(dtype)
    return from_scipy(S), ref_from_scipy(S)


def _close(got, want, dtype):
    """Equal pattern, values within TOL[dtype] of the largest."""
    g, w = to_scipy(got).tocsr(), ref_to_scipy(want).tocsr()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    if w.nnz:
        scale = np.abs(w.data).max()
        assert np.abs(g.data - w.data).max() <= TOL[dtype] * scale


# -- gallery/diffusion.py ------------------------------------------------------

@pytest.mark.parametrize("kind", ["FE", "FD"])
@pytest.mark.parametrize("epsilon,theta", [(1.0, 0.0), (1e-3, np.pi / 8),
                                           (0.1, np.pi / 3), (5.0, -0.7)])
def test_diffusion_stencil_2d_matches_reference(kind, epsilon, theta):
    np.testing.assert_array_equal(
        diffusion_stencil_2d(epsilon, theta, kind),
        ref_stencil_2d(epsilon, theta, kind))


@pytest.mark.parametrize("args", [(), (0.1, 0.01, np.pi / 8, 0.3, -0.2),
                                  (1e-3, 1.0, 0.0, np.pi / 4, 0.0)])
def test_diffusion_stencil_3d_matches_reference(args):
    np.testing.assert_array_equal(diffusion_stencil_3d(*args),
                                  ref_stencil_3d(*args))


def test_diffusion_stencils_check_their_type():
    with pytest.raises(ValueError):
        diffusion_stencil_2d(type="FV")
    with pytest.raises(ValueError):
        diffusion_stencil_3d(type="FE")


# -- the evolution measure -----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("k,epsilon", [(1, 4.0), (2, 4.0), (4, 4.0),
                                       (2, 2.0), (2, np.inf)])
def test_band_route_matches_reference(k, epsilon, symmetrize, dtype):
    A, Ar = _anisotropic(24, dtype)
    assert evolution._evolution_dia_fast(
        A, np.ones(A.shape[0]), epsilon, k, symmetrize) is not None
    _close(evolution.evolution_strength_of_connection(
        A, epsilon=epsilon, k=k, symmetrize_measure=symmetrize),
        ref_evolution.evolution_strength_of_connection(
            Ar, epsilon=epsilon, k=k, symmetrize_measure=symmetrize), dtype)


def _general_only(monkeypatch):
    """Both packages without their band route (a test-local patch)."""
    monkeypatch.setattr(evolution, "_evolution_dia_fast",
                        lambda *args: None)
    monkeypatch.setattr(ref_evolution, "_evolution_dia_fast",
                        lambda *args: None)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("k", [1, 2, 4, 3])
@pytest.mark.parametrize("matrix", ["anisotropic", "unbanded"])
def test_general_route_matches_reference(matrix, k, symmetrize, dtype,
                                         monkeypatch):
    if matrix == "anisotropic":
        A, Ar = _anisotropic(20, dtype)
        _general_only(monkeypatch)
    else:
        A, Ar = _unbanded(dtype=dtype)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = evolution.evolution_strength_of_connection(
            A, k=k, symmetrize_measure=symmetrize)
    assert any("powers of two" in str(w.message) for w in caught) == \
        (k == 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = ref_evolution.evolution_strength_of_connection(
            Ar, k=k, symmetrize_measure=symmetrize)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("symmetrize", [True, False])
@pytest.mark.parametrize("proj_type", ["l2", "D_A"])
@pytest.mark.parametrize("k", [2, 4, 3])
def test_multi_candidate_measure_matches_reference(k, proj_type, symmetrize,
                                                   dtype):
    A, Ar = _anisotropic(16, dtype)
    x = np.arange(A.shape[0], dtype=np.float64) % 16
    B = np.stack([np.ones(A.shape[0]), x / 16.0], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = evolution.evolution_strength_of_connection(
            A, B=B, k=k, proj_type=proj_type, symmetrize_measure=symmetrize)
        want = ref_evolution.evolution_strength_of_connection(
            Ar, B=B, k=k, proj_type=proj_type, symmetrize_measure=symmetrize)
    _close(got, want, dtype)


@pytest.mark.parametrize("candidates", ["default", "rigid"])
def test_block_operator_matches_reference(candidates, monkeypatch):
    """A BELL is measured on its scalar form, PDE-local couplings only:
    that measure equals the JAX package's (caught where it sets the unit
    diagonal, a test-local patch).  The port then reduces each block to
    its smallest non-zero entry, where the JAX package's minimum over the
    whole block leaves every block 0 and its graph empty."""
    import pyamg_tpu.ops.arith as ref_arith
    A, B = linear_elasticity((6, 6))
    Ar, _ = ref_elasticity((6, 6))
    B = None if candidates == "default" else B
    caught = []
    with_diagonal = ref_arith.with_diagonal

    def catch(*args):
        caught.append(with_diagonal(*args))
        return caught[-1]

    monkeypatch.setattr(ref_arith, "with_diagonal", catch)
    want = ref_evolution.evolution_strength_of_connection(Ar, B=B)
    assert want.nnz == 0
    got = evolution.evolution_strength_of_connection(A, B=B)
    assert got.shape == (36, 36) and got.nnz > 36
    measure = from_scipy(ref_to_scipy(caught[-1]))
    expect = evolution._distances_to_strength(
        evolution._min_blocks(measure, 2))
    _same_ell(got, expect)


def test_min_blocks_takes_the_smallest_nonzero():
    # (2, 2) holds a stored zero: a block of zeros
    S = sp.csr_matrix(([0.5, 3.0, 2.0, 0.0], ([0, 0, 1, 2], [0, 2, 1, 2])),
                      shape=(4, 4))
    got = to_scipy(evolution._min_blocks(from_scipy(S), 2)).toarray()
    big = np.finfo(np.float64).max
    np.testing.assert_array_equal(got, [[0.5, 3.0], [0.0, big]])


def _same_ell(got, want):
    np.testing.assert_array_equal(got.row_nnz, want.row_nnz)
    mask = want.valid_mask()
    np.testing.assert_array_equal(got.cols[mask], want.cols[mask])
    np.testing.assert_array_equal(got.vals[mask], want.vals[mask])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_band_takes_the_band_route_where_the_reference_fails(dtype):
    """k = 4 squares a band that reaches past half the rows: the
    reference's band route raises on it; the port's gives the measure of
    the reference's general route."""
    A, Ar = _wide(dtype=dtype)
    with pytest.raises(ValueError):
        ref_evolution.evolution_strength_of_connection(Ar, k=4)
    got = evolution.evolution_strength_of_connection(A, k=4)
    saved = ref_evolution._evolution_dia_fast
    ref_evolution._evolution_dia_fast = lambda *args: None
    try:
        want = ref_evolution.evolution_strength_of_connection(Ar, k=4)
    finally:
        ref_evolution._evolution_dia_fast = saved
    _close(got, want, dtype)


@pytest.mark.parametrize("kw", [{"epsilon": 0.5}, {"k": 0},
                                {"proj_type": "l1"}])
def test_evolution_checks_its_arguments(kw):
    A, Ar = _anisotropic(8)
    with pytest.raises(ValueError):
        ref_evolution.evolution_strength_of_connection(Ar, **kw)
    with pytest.raises(ValueError):
        evolution.evolution_strength_of_connection(A, **kw)


@pytest.mark.parametrize("name", ["evolution", "ode"])
def test_strength_measure_dispatches_evolution(name):
    A, Ar = _anisotropic(12, np.float32)
    spec = (name, {"k": 2, "epsilon": 3.0})
    _close(strength_measure(A, spec), ref_strength_measure(Ar, spec),
           np.float32)


def test_strength_measure_raises_for_unported_and_unknown_names():
    """Every measure the JAX package names is ported now (``energy_based``
    among them, held against it); an unknown name raises."""
    A, Ar = _anisotropic(8)
    _close(strength_measure(A, ("energy_based", {})),
           ref_strength_measure(Ar, ("energy_based", {})), np.float64)
    with pytest.raises(ValueError):
        strength_measure(A, ("no_such_measure", {}))


# -- the hierarchy and the solve (BASELINE config 3 at 64^2) -------------------

SA = dict(strength=("evolution", {}), aggregate=("grid", {}), max_coarse=20)
SOLVE = dict(tol=1e-10, inner_maxiter=60, max_outer=20)


@pytest.fixture(scope="module")
def hierarchies():
    A, Ar = _anisotropic(64)
    ml = smoothed_aggregation_solver(A.astype(np.float32), **SA)
    mr = ref_sa(Ar.astype(jnp.float32), **SA)
    return A, ml.compress_stencils(), mr.compress_stencils()


def _layouts(ml):
    return [tuple(type(getattr(l, a, None)).__name__ for a in "APR")
            for l in ml.levels]


def test_anisotropic_hierarchy_matches_reference(hierarchies):
    _, ml, mr = hierarchies
    assert [l.A.shape[0] for l in ml.levels] == \
        [int(l.A.shape[0]) for l in mr.levels] == [4096, 484, 64, 9]
    assert abs(ml.operator_complexity() - mr.operator_complexity()) <= 1e-12
    assert _layouts(ml) == _layouts(mr) == \
        [("DIA", "PhaseStencil", "PhaseStencil")] * 3 + \
        [("DIA", "NoneType", "NoneType")]
    assert [len(l.A.offsets) for l in ml.levels] == \
        [len(l.A.offsets) for l in mr.levels] == [9] * 4
    assert set(ml.setup_timings()) == set(mr.setup_timings())
    for lp, lr in zip(ml.levels, mr.levels):
        np.testing.assert_array_equal(
            to_scipy(lp.A_ell).toarray(), ref_to_scipy(lr.A_ell).toarray())


def test_anisotropic_solve_takes_the_reference_iterations(hierarchies):
    A, ml, mr = hierarchies
    S = to_scipy(A)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    ml.to_device("cpu")
    it = {}
    x = ml.solve_refined(b, A_fine=S, iterations_out=it, **SOLVE)
    inner = []
    solve = mr.solve

    def counted(rhs, **kw):
        res = []
        out = solve(rhs, residuals=res, **kw)
        inner.append(len(res) - 1)
        return out

    mr.solve = counted
    hist = []
    mr.solve_refined(b, A_fine=S, residuals=hist, **SOLVE)
    assert it["outer"] == len(hist) - 1 == 3
    assert len(it["inner"]) == len(inner) and \
        all(abs(a - c) <= 1 for a, c in zip(it["inner"], inner))
    assert np.linalg.norm(b - S @ x) / np.linalg.norm(b) < 1e-10
