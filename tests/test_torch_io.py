"""The port's checkpoints (``pyamg_tpu_torch/io.py``) on the CPU.

The port's own round trip gives the identical residual history and x
for SA compressed to DIA and PhaseStencil levels, SA with SELL levels,
Ruge-Stuben with an LU coarse solve, SA on BELL elasticity blocks and SA
with Schwarz smoothing and a Cholesky coarse solve, placed or not
(tolerance 0).  A file that the JAX package wrote loads in the port and
solves with the JAX package's residual history (within 1e-10 of the
first residual in float64; 1e-6 with float32 SELL levels, the JAX
package's SELL kernels in interpret mode).  A loaded hierarchy lands on the host.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.classical import ruge_stuben_solver as ref_rs
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.io import save_hierarchy as ref_save

from pyamg_tpu_torch import load_hierarchy, save_hierarchy
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.classical import ruge_stuben_solver
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.sparse.sell import SELL

from jax_sell_reference import sellify, use_interpret

torch.set_num_threads(1)

SCHWARZ = dict(presmoother=("schwarz", {"iterations": 2}),
               postsmoother="strength_based_schwarz", keep=True,
               coarse_solver="cholesky")


def _port(name):
    if name == "SA DIA and PhaseStencil":
        return smoothed_aggregation_solver(
            poisson((24, 24)), aggregate=("grid", {}),
            max_coarse=10).compress_stencils()
    if name == "SA SELL":
        return smoothed_aggregation_solver(
            poisson((10, 10, 10)).astype(np.float32),
            max_coarse=20).compress_stencils()
    if name == "RS LU":
        return ruge_stuben_solver(poisson((16, 16)), coarse_solver="lu")
    if name == "BELL elasticity":
        A, B = linear_elasticity((8, 8))
        return smoothed_aggregation_solver(A, B=B, max_coarse=12)
    return smoothed_aggregation_solver(poisson((16, 16)), max_coarse=20,
                                       **SCHWARZ)


def _jax(name):
    if name == "SA DIA and PhaseStencil":
        return ref_sa(ref_poisson((24, 24)), aggregate=("grid", {}),
                      max_coarse=10).compress_stencils()
    if name == "SA SELL":
        return sellify(ref_sa(ref_poisson((10, 10, 10)).astype(
            jnp.float32), max_coarse=20))
    if name == "RS LU":
        return ref_rs(ref_poisson((16, 16)), coarse_solver="lu")
    if name == "BELL elasticity":
        A, B = ref_elasticity((8, 8))
        return ref_sa(A, B=np.asarray(B), max_coarse=12)
    if name == "SA Gauss-Seidel NR":
        return ref_sa(ref_poisson((16, 16)), max_coarse=20,
                      presmoother=("gauss_seidel_nr", {"sweep": "symmetric"}),
                      postsmoother=("gauss_seidel_nr", {"sweep": "symmetric"}))
    return ref_sa(ref_poisson((16, 16)), max_coarse=20, **SCHWARZ)


PORT = ["SA DIA and PhaseStencil", "SA SELL", "RS LU", "BELL elasticity",
        "SA Schwarz Cholesky"]


def _solve(ml, b, maxiter=12):
    res = []
    x = ml.solve(b, maxiter=maxiter, tol=1e-12, residuals=res)
    return np.asarray(res), x.cpu().numpy()


@pytest.mark.parametrize("placed", [False, True], ids=["host", "placed"])
@pytest.mark.parametrize("name", PORT)
def test_round_trip_is_identical(name, placed, tmp_path):
    ml = _port(name)
    if placed:
        ml.to_device("cpu")
    path = str(tmp_path / "h.npz")
    save_hierarchy(ml, path)
    loaded = load_hierarchy(path)
    assert loaded.device is None
    assert [type(l.A) for l in loaded.levels] == \
        [type(l.A) for l in ml.levels]
    b = np.random.default_rng(5).standard_normal(ml.levels[0].A.shape[0])
    r1, x1 = _solve(ml.to_device("cpu"), b)
    r2, x2 = _solve(loaded.to_device("cpu"), b)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(x1, x2)


@pytest.mark.parametrize("name", PORT[:4] + ["SA Gauss-Seidel NR",
                                             "SA Schwarz Cholesky"])
def test_reference_file_solves_as_the_reference(name, tmp_path,
                                                monkeypatch):
    """The smoothers whose stored parameters the port's form lacks
    (Gauss-Seidel on the normal equations, Schwarz, the Cholesky
    coarse solve) are completed on the loaded A."""
    use_interpret(monkeypatch.setattr)
    mr = _jax(name)
    path = str(tmp_path / "ref.npz")
    ref_save(mr, path)
    ml = load_hierarchy(path)
    if name == "SA SELL":
        assert any(isinstance(l.A, SELL) for l in ml.levels)
    b = np.random.default_rng(5).standard_normal(ml.levels[0].A.shape[0])
    want = []
    mr.solve(jnp.asarray(b, mr.levels[0].A.dtype), maxiter=12, tol=1e-12,
             residuals=want)
    got, _ = _solve(ml.to_device("cpu"), b)
    want = np.asarray(want)
    assert len(got) == len(want)
    # float32 SELL levels: 1e-6 of the first residual
    tol = 1e-6 if name == "SA SELL" else 1e-10
    assert np.abs(got - want).max() <= tol * want[0]
