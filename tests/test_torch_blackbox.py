"""The port's one-call solve (``pyamg_tpu_torch/blackbox.py``) against the
JAX package's, on the CPU.

``solver_configuration`` equals the JAX package's on a symmetric matrix
(2-D Poisson), a nonsymmetric one (upwind advection 12^2) and a BELL
(linear elasticity 6^2), candidates included.  ``solve`` on 2-D Poisson
20^2 (and on the advection matrix, by GMRES) takes the JAX package's
iterations, with x within 1e-10 of the largest entry; a hierarchy given
as ``existing_solver`` is reused; a wrong-size hierarchy raises
``TypeError``, and so does a failed setup, from its cause.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import pyamg_tpu.blackbox as ref
from pyamg_tpu.gallery import advection_2d as ref_advection
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson

import pyamg_tpu_torch
from pyamg_tpu_torch import blackbox
from pyamg_tpu_torch.gallery import advection_2d, linear_elasticity, poisson
from pyamg_tpu_torch.sparse.matrix import to_scipy

torch.set_num_threads(1)


def _matrices(name):
    if name == "symmetric":
        return poisson((10, 10)), ref_poisson((10, 10))
    if name == "nonsymmetric":
        return advection_2d((12, 12))[0], ref_advection((12, 12))[0]
    return linear_elasticity((6, 6))[0], ref_elasticity((6, 6))[0]


@pytest.mark.parametrize("name", ["symmetric", "nonsymmetric", "BELL"])
def test_configuration_matches_reference(name):
    A, Ar = _matrices(name)
    got = blackbox.solver_configuration(A, verb=False)
    want = ref.solver_configuration(Ar, verb=False)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray) or hasattr(v, "shape"):
            np.testing.assert_array_equal(got[k], np.asarray(v))
        else:
            assert got[k] == v, k
    assert got["symmetry"] == ("nonsymmetric" if name == "nonsymmetric"
                               else "hermitian")


def test_configuration_takes_and_checks_candidates():
    A, Ar = _matrices("symmetric")
    B = np.arange(A.shape[0], dtype=float)
    got = blackbox.solver_configuration(A, B=B, verb=False)
    np.testing.assert_array_equal(
        got["B"], ref.solver_configuration(Ar, B=B, verb=False)["B"])
    with pytest.raises(TypeError):
        blackbox.solver_configuration(A, B=np.ones(3), verb=False)


@pytest.mark.parametrize("name", ["symmetric", "nonsymmetric"])
def test_solve_matches_reference(name, capsys):
    """Iterations and x of a fresh solve (x0 from ``default_rng(17)``)."""
    if name == "symmetric":
        A, Ar = poisson((20, 20)), ref_poisson((20, 20))
    else:
        A, Ar = _matrices(name)
    b = np.random.default_rng(0).random(A.shape[0])
    got, want = [], []
    x = blackbox.solve(A, b, tol=1e-8, residuals=got, device="cpu")
    xr = np.asarray(ref.solve(Ar, jnp.asarray(b), tol=1e-8, residuals=want))
    accel = "cg" if name == "symmetric" else "gmres"
    assert f"Using {accel} acceleration" in capsys.readouterr().out
    assert len(got) == len(want)
    assert np.abs(x.numpy() - xr).max() <= 1e-10 * np.abs(xr).max()
    assert np.linalg.norm(b - to_scipy(A) @ x.numpy()) <= \
        1e-8 * np.linalg.norm(b) * 10


def test_existing_solver_is_reused():
    A = poisson((20, 20))
    b = np.random.default_rng(0).random(A.shape[0])
    x, ml = blackbox.solve(A, b, tol=1e-8, return_solver=True, verb=False,
                           device="cpu")
    assert ml.device == torch.device("cpu")
    first, again = [], []
    blackbox.solve(A, b, tol=1e-8, verb=False, residuals=first,
                   device="cpu")
    x2, ml2 = blackbox.solve(A, b, tol=1e-8, existing_solver=ml,
                             return_solver=True, verb=False,
                             residuals=again, device="cpu")
    assert ml2 is ml
    assert again == first
    np.testing.assert_array_equal(x2.numpy(), x.numpy())


def test_wrong_size_solver_raises():
    _, ml = blackbox.solve(poisson((6, 6)), np.ones(36), return_solver=True,
                           verb=False, device="cpu")
    with pytest.raises(TypeError, match="same size"):
        blackbox.solve(poisson((7, 7)), np.ones(49), existing_solver=ml,
                       verb=False, device="cpu")


def test_failed_setup_raises_from_its_cause():
    A = poisson((6, 6))
    config = blackbox.solver_configuration(A, verb=False)
    config["coarse_solver"] = "no such solver"
    with pytest.raises(TypeError) as e:
        blackbox.solver(A, config)
    assert isinstance(e.value.__cause__, ValueError)


def test_solve_goes_to_the_card_by_default():
    assert inspect.signature(blackbox.solve).parameters["device"].default \
        == "cuda"
    for name in ("solve", "solver", "solver_configuration",
                 "coarse_grid_solver", "gallery", "util"):
        assert hasattr(pyamg_tpu_torch, name)
