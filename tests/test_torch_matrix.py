"""The port's sparse containers against the JAX package's.

``dia_from_ell`` and ``phase_stencil_from_ell`` must build the same
arrays as the reference from the same ELL, and ``PhaseStencil``'s forward
and adjoint products (torch slice ops) must equal the reference's on the
CPU (float64, atol 1e-12: the same sums in the same order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.ops.spmv import matvec as ref_matvec
from pyamg_tpu.sparse import matrix as ref_matrix

from pyamg_tpu_torch.sparse import matrix as tm
from pyamg_tpu_torch.ops.spmv import matvec
from pyamg_tpu_torch.ops.transpose import transpose

torch.set_num_threads(1)


def _port_ell(A):
    """The reference ELL's arrays as a port ELL."""
    return tm.ELL(np.asarray(A.cols), np.asarray(A.vals),
                  np.asarray(A.row_nnz), tuple(A.shape), A.grid, A.col_grid)


@pytest.mark.parametrize("grid", [(40,), (17, 13), (6, 5, 7)])
def test_dia_from_ell_matches_reference(grid):
    A = ref_poisson(grid)
    ref = ref_matrix.dia_from_ell(A)
    got = tm.dia_from_ell(_port_ell(A))
    assert got.offsets == ref.offsets and got.shape == ref.shape
    assert got.data.shape[1] % tm.DIA_TILE == 0
    np.testing.assert_array_equal(got.data, np.asarray(ref.data))


def test_dia_from_ell_rejects_wide_and_rectangular():
    rng = np.random.default_rng(0)
    import scipy.sparse as sp
    M = sp.random(60, 60, density=0.5, random_state=1, format="csr")
    assert tm.dia_from_ell(tm.from_scipy(M), max_diags=8) is None
    R = sp.random(60, 30, density=0.1, random_state=2, format="csr")
    assert tm.dia_from_ell(tm.from_scipy(R)) is None
    x = rng.standard_normal(60)
    np.testing.assert_allclose(tm.to_scipy(tm.from_scipy(M)) @ x, M @ x,
                               rtol=1e-12)


@pytest.mark.parametrize("grid", [(26,), (17, 13), (7, 6, 5)])
def test_phase_stencil_matches_reference(grid):
    """Every compressed transfer of a grid-SA hierarchy: same stencil
    arrays as the reference, and the same P x and R y."""
    ml = ref_sa(ref_poisson(grid), aggregate=("grid", {}), max_coarse=3,
                max_levels=3)
    P0 = [lvl.P for lvl in ml.levels[:-1]]
    R0 = [lvl.R for lvl in ml.levels[:-1]]
    ml.compress_stencils()
    rng = np.random.default_rng(0)
    compressed = 0
    for i, lvl in enumerate(ml.levels[:-1]):
        if not isinstance(lvl.P, ref_matrix.PhaseStencil):
            continue
        compressed += 1
        P = tm.phase_stencil_from_ell(_port_ell(P0[i]), P0[i].grid,
                                      P0[i].col_grid)
        Rt = tm.phase_stencil_from_ell(transpose(_port_ell(R0[i])),
                                       P0[i].grid, P0[i].col_grid).T
        for got, ref in ((P, lvl.P), (Rt, lvl.R)):
            assert got.offsets == ref.offsets and got.ratio == ref.ratio
            assert got.shape == ref.shape and got.nnz == ref.nnz
            for a, b in zip(got.arrays, ref.arrays):
                np.testing.assert_array_equal(a, np.asarray(b))
        P, Rt = P.to("cpu"), Rt.to("cpu")
        xc = rng.standard_normal(P.shape[1])
        xf = rng.standard_normal(P.shape[0])
        np.testing.assert_allclose(
            matvec(P, torch.as_tensor(xc)).numpy(),
            np.asarray(ref_matvec(lvl.P, jnp.asarray(xc))), rtol=0,
            atol=1e-12)
        np.testing.assert_allclose(
            matvec(Rt, torch.as_tensor(xf)).numpy(),
            np.asarray(ref_matvec(lvl.R, jnp.asarray(xf))), rtol=0,
            atol=1e-12)
    assert compressed >= 1


def test_ell_roundtrip_and_asarray():
    A = tm.from_scipy(ref_matrix.to_scipy(ref_poisson((9, 8))))
    S = tm.to_scipy(A)
    np.testing.assert_array_equal(S.toarray(),
                                  ref_matrix.to_scipy(ref_poisson((9, 8)))
                                  .toarray())
    B = tm.asarray_or_ell(S.toarray(), dtype=np.float32)
    assert B.dtype == np.float32 and B.nnz == A.nnz
    D = tm.dia_from_ell(A)
    np.testing.assert_array_equal(tm.to_scipy(D).toarray(), S.toarray())
