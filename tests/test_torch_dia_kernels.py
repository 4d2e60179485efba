"""The plain versions of kernels K1 (banded SpMV) and K2 (multicolor GS
sweep) against the JAX package on the CPU, on what the JAX package takes:
any number of diagonals and x of shape (n,) or (n, k).

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
import scipy.sparse as sp
import torch

from pyamg_tpu.ops.spmv import dia_spmv as ref_dia_spmv
from pyamg_tpu.relaxation.relaxation import gauss_seidel as ref_gs
from pyamg_tpu.sparse import matrix as ref_matrix
from pyamg_tpu.sparse.matrix import DIA as RefDIA

from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.ops.spmv import dia_spmv
from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gauss_seidel,
                                                   gs_order, make_coloring)
from pyamg_tpu_torch.sparse.matrix import (DIA, DIA_TILE, dia_from_ell,
                                           from_scipy)

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
    with pytest.raises(ValueError):                 # b unlike x
        dk.dia_gs_sweep(data, (-1, 0, 1), 10, torch.zeros(10, 2), x, x,
                        torch.zeros(10, dtype=torch.int32), [0])
    with pytest.raises(ValueError):                 # x neither (n,) nor (n, k)
        dk.dia_spmv(data, (-1, 0, 1), 10, torch.zeros(10, 2, 2))


def _ref_gs(D, x, b, colors, nc, Dinv, sweep="symmetric", omega=1.0):
    """The JAX package's gauss_seidel on the DIA ``D`` (its jnp path)."""
    Dr = RefDIA(jnp.asarray(np.asarray(D.data)), D.offsets, D.shape)
    return np.asarray(jax.jit(lambda x, b: ref_gs(
        Dr, x, b, iterations=1, sweep=sweep, colors=jnp.asarray(colors),
        ncolors=nc, Dinv=jnp.asarray(Dinv), omega=omega))(
            jnp.asarray(x), jnp.asarray(b)))


def _assert_close(got, want, dtype):
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype],
                               atol=RTOL[dtype] * np.abs(want).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_more_than_64_diagonals_like_reference(dtype):
    """A band of 80 diagonals through dia_spmv and gauss_seidel (the
    port's kernels used to take at most 64)."""
    rng = np.random.default_rng(80)
    n = 600
    offsets = tuple(sorted({0, *rng.choice(np.arange(-250, 251), 79,
                                           replace=False).tolist()}))
    while len(offsets) < 80:
        offsets = tuple(sorted({*offsets, int(rng.integers(-250, 251))}))
    npad = -(-n // DIA_TILE) * DIA_TILE
    data = np.zeros((80, npad), dtype)
    data[:, :n] = rng.standard_normal((80, n)) * 0.01
    data[offsets.index(0), :n] = 2.0
    D = DIA(torch.as_tensor(data), offsets, (n, n))
    x = rng.standard_normal(n).astype(dtype)
    b = rng.standard_normal(n).astype(dtype)
    colors = rng.integers(0, 3, n).astype(np.int32)
    Dinv = (1.0 / data[offsets.index(0), :n]).astype(dtype)
    want = np.asarray(ref_dia_spmv(RefDIA(jnp.asarray(data), offsets,
                                          (n, n)), jnp.asarray(x)))
    _assert_close(dia_spmv(D, torch.as_tensor(x)).numpy(), want, dtype)
    want = _ref_gs(D, x, b, colors, 3, Dinv, omega=0.8)
    got = gauss_seidel(D, torch.as_tensor(x), torch.as_tensor(b),
                       sweep="symmetric", colors=torch.as_tensor(colors),
                       ncolors=3, Dinv=torch.as_tensor(Dinv), omega=0.8)
    _assert_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_multi_column_x_like_reference(levels, level, omega):
    """x and b of shape (n, 3) through dia_spmv and gauss_seidel at 48^2
    levels 0 and 1, against the JAX package, and column by column against
    the 1-D path."""
    D, colors, nc, Dinv = levels[level]
    n = D.shape[0]
    rng = np.random.default_rng(3 + level)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    b = rng.standard_normal((n, 3)).astype(np.float32)
    Dt = D.to("cpu")
    y = dia_spmv(Dt, torch.as_tensor(x))
    assert y.shape == (n, 3)
    want = np.asarray(ref_dia_spmv(RefDIA(jnp.asarray(D.data), D.offsets,
                                          D.shape), jnp.asarray(x)))
    _assert_close(y.numpy(), want, np.float32)
    for j in range(3):
        assert torch.equal(y[:, j], dia_spmv(Dt, torch.tensor(x[:, j])))
    args = dict(sweep="symmetric", colors=torch.as_tensor(colors),
                ncolors=nc, Dinv=torch.as_tensor(Dinv), omega=omega)
    got = gauss_seidel(Dt, torch.as_tensor(x), torch.as_tensor(b), **args)
    assert got.shape == (n, 3)
    _assert_close(got.numpy(), _ref_gs(D, x, b, colors, nc, Dinv,
                                       omega=omega), np.float32)
    for j in range(3):
        assert torch.equal(got[:, j], gauss_seidel(
            Dt, torch.tensor(x[:, j]), torch.tensor(b[:, j]), **args))


def test_three_column_x_level1_like_reference(levels):
    """x of shape (n, 3) through the wrapper (one product, the plain
    version on the CPU) at 48^2 level 1 against the JAX package's jnp
    path, to 1e-6 relative in float32 (sums of 9 products in the same
    order)."""
    D, _, _, _ = levels[1]
    n = D.shape[0]
    x = np.random.default_rng(31).standard_normal((n, 3)).astype(np.float32)
    before = dk.dia_spmv.launches
    got = dk.dia_spmv(torch.as_tensor(np.asarray(D.data)), D.offsets, n,
                      torch.as_tensor(x))
    assert dk.dia_spmv.launches == before and got.shape == (n, 3)
    want = np.asarray(ref_dia_spmv(RefDIA(jnp.asarray(D.data), D.offsets,
                                          D.shape), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_dia_from_ell_past_64_offsets_like_reference():
    """dia_from_ell(max_diags=100) on a host operator with 90 distinct
    offsets: the port and the JAX package build the same band, and their
    products agree."""
    rng = np.random.default_rng(90)
    n = 400
    offs = rng.choice(np.arange(-n + 1, n), 90, replace=False)
    rows = np.concatenate([np.arange(max(0, -o), min(n, n - o))
                           for o in offs])
    cols = np.concatenate([np.arange(max(0, -o), min(n, n - o)) + o
                           for o in offs])
    M = sp.csr_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, n))
    assert len(np.unique(offs)) == 90
    ref = ref_matrix.dia_from_ell(ref_matrix.from_scipy(M), max_diags=100)
    got = dia_from_ell(from_scipy(M), max_diags=100)
    assert dia_from_ell(from_scipy(M)) is None        # past the default 64
    assert got.offsets == ref.offsets and len(got.offsets) == 90
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))
    x = rng.standard_normal(n)
    want = np.asarray(ref_dia_spmv(ref, jnp.asarray(x)))
    y = dia_spmv(got.to("cpu"), torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(y.numpy(), M @ x, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
