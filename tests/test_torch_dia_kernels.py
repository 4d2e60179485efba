"""The plain versions of kernels K1 (banded SpMV) and K2 (multicolor GS
sweep) against the JAX package on the CPU.

On the CPU ``pallas_available()`` is False, so ``pyamg_tpu``'s
``dia_spmv`` and ``gauss_seidel`` take their jnp formulations: the same
reference the JAX suite holds its Pallas kernels to.  The port's wrappers
take their plain versions because the tensors lie on the CPU.  Tolerances:
float32 rtol 1e-5 (sums of at most 9 products, in the same order but
through another library's kernels), float64 rtol 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.ops.spmv import dia_spmv as ref_dia_spmv
from pyamg_tpu.relaxation.relaxation import gauss_seidel as ref_gs
from pyamg_tpu.sparse.matrix import DIA as RefDIA

from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.ops.spmv import dia_spmv
from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gauss_seidel,
                                                   gs_order, make_coloring)
from pyamg_tpu_torch.sparse.matrix import DIA, DIA_TILE, dia_from_ell

torch.set_num_threads(1)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n, offsets", [
    (40, (-50, -7, -1, 0, 3, 9, 41)),      # offsets past both ends
    (300, (-17, -1, 0, 1, 17)),
    (8200, (-128, -3, 0, 5, 129)),         # rows past one DIA_TILE
])
def test_dia_spmv_plain_matches_reference(dtype, n, offsets):
    rng = np.random.default_rng(n)
    npad = -(-n // DIA_TILE) * DIA_TILE
    data = np.zeros((len(offsets), npad), dtype)
    data[:, :n] = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n).astype(dtype)
    want = np.asarray(ref_dia_spmv(RefDIA(jnp.asarray(data), offsets,
                                          (n, n)), jnp.asarray(x)))
    before = dk.dia_spmv.launches
    got = dia_spmv(DIA(torch.as_tensor(data), offsets, (n, n)),
                   torch.as_tensor(x))
    assert dk.dia_spmv.launches == before      # CPU: the plain version
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())


def _levels():
    """The two DIA levels of a grid-SA hierarchy at 48^2 (5- and 9-point
    operators) with their colorings, from the port's setup."""
    ml = smoothed_aggregation_solver(poisson((48, 48)).astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    out = []
    for lvl in ml.levels[:2]:
        colors, nc = make_coloring(lvl.A)
        out.append((dia_from_ell(lvl.A), colors, nc, dinv_vec(lvl.A)))
    return out


@pytest.fixture(scope="module")
def levels():
    return _levels()


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_gs_sweep_plain_matches_reference(levels, level, sweep, omega):
    D, colors, nc, Dinv = levels[level]
    n = D.shape[0]
    rng = np.random.default_rng(level)
    x = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    Dr = RefDIA(jnp.asarray(D.data), D.offsets, D.shape)
    want = np.asarray(jax.jit(lambda x, b: ref_gs(
        Dr, x, b, iterations=2, sweep=sweep, colors=jnp.asarray(colors),
        ncolors=nc, Dinv=jnp.asarray(Dinv), omega=omega))(
            jnp.asarray(x), jnp.asarray(b)))
    Dt = D.to("cpu")
    before = dk.dia_gs_sweep.launches
    got = gauss_seidel(Dt, torch.as_tensor(x), torch.as_tensor(b),
                       iterations=2, sweep=sweep,
                       colors=torch.as_tensor(colors), ncolors=nc,
                       Dinv=torch.as_tensor(Dinv), omega=omega)
    assert dk.dia_gs_sweep.launches == before
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_gs_order_collapses_repeats_at_omega_one():
    assert gs_order(2, "symmetric") == [0, 1, 0]
    assert gs_order(4, "symmetric", iterations=2) == \
        [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1, 0]
    assert gs_order(2, "symmetric", omega=0.8) == [0, 1, 1, 0]
    assert gs_order(3, "backward") == [2, 1, 0]


def test_wrappers_check_their_operands():
    data = torch.zeros((3, DIA_TILE), dtype=torch.float32)
    x = torch.zeros(10)
    with pytest.raises(TypeError):
        dk.dia_spmv(data.to(torch.complex64), (-1, 0, 1), 10,
                    x.to(torch.complex64))
    with pytest.raises(TypeError):
        dk.dia_spmv(data, (-1, 0, 1), 10, x.double())
    with pytest.raises(ValueError):
        dk.dia_spmv(data, (-1, 0), 10, x)
    with pytest.raises(ValueError):
        dk.dia_spmv(data, (-1, 0, 1), 10, torch.zeros(20)[::2])
    with pytest.raises(TypeError):
        dk.dia_gs_sweep(data, (-1, 0, 1), 10, x, x, x,
                        torch.zeros(10, dtype=torch.int64), [0])
