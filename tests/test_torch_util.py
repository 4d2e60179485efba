"""The port's utilities (``pyamg_tpu_torch/util``) against the JAX
package's, on the CPU: ``set_tol``, norms, ``condest``, ``ishermitian``
(Hermitian, real nonsymmetric and complex Hermitian inputs, fast and
exact), row and column scaling, symmetric rescaling with candidates,
diagonals of A and of the normal equations, block diagonals,
amalgamation, rigid-body modes, the column filter, row scaling by the
largest entry, the hierarchy spectrum and ``profile_solver``.  Arrays
equal within 1e-12 of their largest entry (exact for integer and
pattern results), scalars within 1e-12 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pyamg_tpu.util as ref
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import advection_2d as ref_advection
from pyamg_tpu.gallery import gauge_laplacian as ref_gauge
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson

import pyamg_tpu_torch.util as util
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import (advection_2d, gauge_laplacian,
                                     linear_elasticity, poisson)

from test_torch_energy import same_operator

torch.set_num_threads(1)


def _close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max() if want.size else 0.0
    assert np.abs(got - want).max(initial=0) <= tol * max(scale, 1e-300)


def _matrices(name):
    if name == "poisson":
        return poisson((8, 8)), ref_poisson((8, 8))
    if name == "advection":
        return advection_2d((8, 8))[0], ref_advection((8, 8))[0]
    return gauge_laplacian(6, seed=3), ref_gauge(6, seed=3)


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64,
                                   np.complex64, np.complex128,
                                   np.longdouble])
def test_set_tol(dtype):
    assert util.set_tol(dtype) == ref.set_tol(dtype)


def test_set_tol_rejects_integers():
    with pytest.raises(ValueError):
        util.set_tol(np.int32)


@pytest.mark.parametrize("name", ["poisson", "advection", "gauge"])
def test_ishermitian_matches_reference(name):
    A, Ar = _matrices(name)
    for fast in (True, False):
        got = util.ishermitian(A, fast_check=fast)
        assert got == ref.ishermitian(Ar, fast_check=fast)
        assert got == (name != "advection")


@pytest.mark.parametrize("name", ["poisson", "advection"])
def test_norms_and_condest(name):
    A, Ar = _matrices(name)
    x = np.random.default_rng(1).standard_normal(A.shape[0])
    for p in ("2", "inf"):
        _close(util.norm(x, p), ref.norm(x, p))
        _close(util.norm(torch.as_tensor(x), p).numpy(), ref.norm(x, p))
    assert util.infinity_norm(A) == ref.infinity_norm(Ar)
    _close(util.condest(A), ref.condest(Ar))
    with pytest.raises(ValueError):
        util.norm(x, "1")


@pytest.mark.parametrize("name", ["poisson", "advection", "gauge"])
def test_scaling_and_diagonals(name):
    A, Ar = _matrices(name)
    v = np.random.default_rng(2).random(A.shape[0]) + 0.5
    same_operator(util.scale_rows(A, v), ref.scale_rows(Ar, jnp.asarray(v)),
                  1e-12)
    same_operator(util.scale_columns(A, v),
                  ref.scale_columns(Ar, jnp.asarray(v)), 1e-12)
    for got, want in zip(util.symmetric_rescaling(A),
                         ref.symmetric_rescaling(Ar)):
        if isinstance(got, np.ndarray):
            _close(got, want)
        else:
            same_operator(got, want, 1e-12)
    B = np.random.default_rng(3).random((A.shape[0], 2))
    DAD, DB, DBH = util.symmetric_rescaling_sa(A, B, B[:, 0])
    rDAD, rDB, rDBH = ref.symmetric_rescaling_sa(Ar, B, B[:, 0])
    same_operator(DAD, rDAD, 1e-12)
    _close(DB, rDB)
    _close(DBH, rDBH)
    for norm_eq in (False, 1, 2):
        for inv in (False, True):
            _close(util.get_diagonal(A, norm_eq, inv),
                   ref.get_diagonal(Ar, norm_eq, inv))
    same_operator(util.scale_rows_by_largest_entry(A),
                  ref.scale_rows_by_largest_entry(Ar), 1e-12)
    for theta in (0.0, 0.5, 0.9):
        same_operator(util.filter_matrix_columns(A, theta),
                      ref.filter_matrix_columns(Ar, theta), 1e-12)


def test_block_diagonal_and_amalgamation():
    A, Ar = linear_elasticity((4, 4))[0], ref_elasticity((4, 4))[0]
    for inv in (False, True):
        _close(util.get_block_diag(A, inv_flag=inv),
               ref.get_block_diag(Ar, inv_flag=inv))
    S, Sr = poisson((6, 6)), ref_poisson((6, 6))
    same_operator(util.amalgamate(S, 2), ref.amalgamate(Sr, 2), 0)
    same_operator(util.unamal(util.amalgamate(S, 2), 2, 2),
                  ref.unamal(ref.amalgamate(Sr, 2), 2, 2), 0)


@pytest.mark.parametrize("d", [1, 2, 3])
def test_coord_to_rbm(d):
    V = np.random.default_rng(d).random((5, d))
    np.testing.assert_array_equal(util.coord_to_rbm(V), ref.coord_to_rbm(V))
    with pytest.raises(ValueError):
        util.coord_to_rbm(np.ones((3, 4)))


def test_hierarchy_spectrum_and_profile_solver(capsys):
    ml = smoothed_aggregation_solver(poisson((12, 12)), max_coarse=10)
    mr = ref_sa(ref_poisson((12, 12)), max_coarse=10)
    got, want = util.hierarchy_spectrum(ml), ref.hierarchy_spectrum(mr)
    for g, w in zip(got, want):
        _close(np.sort_complex(g), np.sort_complex(w), 1e-10)
    assert "min(re)" in capsys.readouterr().out
    got = util.profile_solver(ml.to_device("cpu"), maxiter=8, tol=1e-12)
    want = ref.profile_solver(mr, maxiter=8, tol=1e-12)
    _close(got, want, 1e-10)
    got = util.profile_solver(ml, accel="cg", maxiter=8, tol=1e-12)
    want = ref.profile_solver(mr, accel="cg", maxiter=8, tol=1e-12)
    _close(got, want, 1e-10)


def test_exports_match_the_reference():
    assert sorted(util.__all__) == sorted(ref.__all__)
    for name in util.__all__:
        assert callable(getattr(util, name))
