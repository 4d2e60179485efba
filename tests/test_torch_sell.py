"""The port's SELL plan, K3/K4 and K5 plain versions against the JAX
package on the CPU.

The JAX package's SELL kernels run as Pallas kernels in interpret mode
(``jax_sell_reference.use_interpret``), the port's wrappers take their
plain versions because the tensors lie on the CPU.  Tolerances: the plan
equal array for array; SpMV to 1e-6 of max |y| (both sum the passes in
the same order, in float32); a Gauss-Seidel sweep to 1e-5 of max |x|.
The squares span at least 3 Gauss-Seidel tiles of 1024 rows, so that the
tile order, the tile-entry reads and the pass-by-pass residual are all
seen.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

import pyamg_tpu.ops.sell_kernels as ref_sk
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.sell import sell_from_ell as ref_sell_from_ell

from jax_sell_reference import use_interpret

from pyamg_tpu_torch.ops import sell_kernels as sk
from pyamg_tpu_torch.ops.spmv import matvec
from pyamg_tpu_torch.relaxation.relaxation import gauss_seidel
from pyamg_tpu_torch.sparse.matrix import ELL, from_scipy, to_scipy
from pyamg_tpu_torch.sparse.sell import SELL, sell_from_ell, sell_to_scipy

torch.set_num_threads(1)

PLAN_FIELDS = ("vals", "delta", "bases", "diag", "shape", "t", "kind", "K",
               "pad_top", "x_rows", "nnz", "base_lo", "base_hi")


def _scattered_square(side, rng, extra=60):
    """2-D Poisson side^2 plus scattered couplings (as tests/test_sell.py)."""
    A = _poisson_csr(side).tolil()
    n = A.shape[0]
    idx = rng.integers(0, n, size=2 * extra)
    for i, j in zip(idx[::2], idx[1::2]):
        A[int(i), int(j)] = rng.standard_normal()
    return sp.csr_matrix(A.astype(np.float32))


def _poisson_csr(side):
    from pyamg_tpu_torch.gallery import poisson
    return to_scipy(poisson((side, side)))


def _tall(rng, n=1024, m=256):
    rows = np.repeat(np.arange(n), 2)
    cols = np.concatenate([np.clip(np.arange(n) // 4, 0, m - 1),
                           np.clip(np.arange(n) // 4 + 1, 0, m - 1)])
    vals = rng.standard_normal(2 * n).astype(np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n, m))


@pytest.fixture(scope="module")
def ref_hierarchy():
    """The JAX package's 24^3 standard-SA hierarchy (uncompressed ELL)."""
    return ref_sa(ref_poisson((24, 24, 24)).astype(jnp.float32),
                  max_coarse=50)


def _operators(ref_hierarchy):
    rng = np.random.default_rng(0)
    sq = _scattered_square(48, rng)
    tall = _tall(rng)
    lv = ref_hierarchy.levels
    return {"square48": sq, "tall": tall, "fat": tall.T.tocsr(),
            "P0": lv[0].P, "R0": lv[0].R, "A1": lv[1].A, "P1": lv[1].P}


CASES = ["square48", "tall", "fat", "P0", "R0", "A1", "P1"]


def _pair(op):
    """(the JAX package's ELL, the port's ELL) of one operator."""
    if sp.issparse(op):
        return ref_from_scipy(op), from_scipy(op)
    return op, ELL(np.asarray(op.cols), np.asarray(op.vals),
                   np.asarray(op.row_nnz), tuple(op.shape))


def _plans(ref_hierarchy, case):
    ref_ell, ell = _pair(_operators(ref_hierarchy)[case])
    return ref_sell_from_ell(ref_ell), sell_from_ell(ell)


def _assert_same_plan(got, ref):
    assert isinstance(got, SELL)
    for f in PLAN_FIELDS:
        g = getattr(got, f)
        r = getattr(ref, f)
        if isinstance(g, np.ndarray):
            r = np.asarray(r)
            assert g.dtype == r.dtype and g.shape == r.shape, f
            np.testing.assert_array_equal(g, r, err_msg=f)
        else:
            assert g == r, f


# -- (a) the plan -------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_plan_equals_reference(ref_hierarchy, case):
    ref, got = _plans(ref_hierarchy, case)
    assert ref is not None
    _assert_same_plan(got, ref)
    assert abs(sell_to_scipy(got) - to_scipy(_pair(
        _operators(ref_hierarchy)[case])[1])).max() < 1e-12


def test_plan_kinds(ref_hierarchy):
    kinds = {}
    for c in CASES:
        plan = _plans(ref_hierarchy, c)[1]
        kinds[c] = (plan.kind, plan.t)
    assert kinds["square48"] == ("tall", 1) and kinds["A1"] == ("tall", 1)
    assert kinds["tall"] == ("tall", 4) and kinds["fat"] == ("fat", 4)
    assert kinds["P0"][0] == "tall" and kinds["P0"][1] > 1
    assert kinds["R0"][0] == "fat"
    assert _plans(ref_hierarchy, "square48")[1].Sy * 128 >= 3 * sk.GS_TILE


def _wide_fat(t, n=1024):
    """n x (n t), two entries a row near the row's anchor column."""
    i = np.arange(n)
    base = 128 * (i // 128) * t + i % 128
    cols = np.concatenate([base, base + 128])
    return sp.csr_matrix((np.ones(2 * n, np.float32), (np.tile(i, 2), cols)),
                         shape=(n, n * t))


@pytest.mark.parametrize("what", ["fat_past_vmem", "float64"])
def test_plan_rejected_alike(what):
    """A fat operator past the reference's VMEM budget (the plan-shaping
    parity rule), and a float64 operator: neither sell_from_ell takes them."""
    S = _wide_fat(1600) if what == "fat_past_vmem" else \
        _poisson_csr(40).astype(np.float64)
    assert ref_sell_from_ell(ref_from_scipy(S)) is None
    assert sell_from_ell(from_scipy(S)) is None
    if what == "fat_past_vmem":
        # a third as wide, its x fits
        half = _wide_fat(500)
        _assert_same_plan(sell_from_ell(from_scipy(half)),
                          ref_sell_from_ell(ref_from_scipy(half)))


# -- (b) K3/K4 plain version --------------------------------------------------

def _spmv_case(ref_hierarchy, case, monkeypatch=None):
    ref, got = _plans(ref_hierarchy, case)
    if monkeypatch is not None:
        # force the reference's tiled (K4) form once its plan is built, as
        # tests/test_sell.py does
        monkeypatch.setattr(ref_sk, "_VMEM_X_BUDGET", 1024)
    x = np.random.default_rng(1).standard_normal(ref.shape[1]) \
        .astype(np.float32)
    want = np.asarray(ref_sk.sell_spmv(ref, jnp.asarray(x), interpret=True))
    before = sk.sell_spmv.launches
    y = matvec(got.to("cpu"), torch.as_tensor(x))
    assert sk.sell_spmv.launches == before       # CPU: the plain version
    assert y.dtype == torch.float32 and y.shape == (ref.shape[0],)
    err = np.abs(y.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("case", CASES)
def test_spmv_plain_matches_reference(ref_hierarchy, case):
    _spmv_case(ref_hierarchy, case)


@pytest.mark.parametrize("case", ["square48", "A1"])
def test_spmv_plain_matches_reference_tiled(ref_hierarchy, case,
                                            monkeypatch):
    """Against the reference's tiled square kernel (K4)."""
    _spmv_case(ref_hierarchy, case, monkeypatch)


def _non_finite_x(m, seed):
    """A float32 x of length m with an inf and a NaN among finite values."""
    x = np.random.default_rng(seed).standard_normal(m).astype(np.float32)
    x[m // 3] = np.inf
    x[(2 * m) // 3] = np.nan
    return x


def _same_non_finite(got, want):
    """Non-finite at the same places, the finite values alike."""
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.abs(got[fin] - want[fin]).max() <= \
        1e-5 * max(1.0, np.abs(want[fin]).max())


@pytest.mark.parametrize("case", ["square48", "tall", "fat", "P0", "R0"])
def test_spmv_plain_non_finite_like_reference(ref_hierarchy, case):
    """Every slot is multiplied, a padded one (value 0) too: where a slot
    reaches an inf or a NaN of x, the plain version gives NaN as the JAX
    package's kernel does."""
    ref, got = _plans(ref_hierarchy, case)
    x = _non_finite_x(ref.shape[1], 4)
    want = np.asarray(ref_sk.sell_spmv(ref, jnp.asarray(x), interpret=True))
    y = sk.sell_spmv(got.to("cpu"), torch.as_tensor(x)).numpy()
    assert not np.isfinite(want).all()
    _same_non_finite(y, want)


def test_spmv_checks_its_operands(ref_hierarchy):
    _, got = _plans(ref_hierarchy, "P0")
    A = got.to("cpu")
    with pytest.raises(TypeError):
        sk.sell_spmv(got, torch.zeros(got.shape[1]))      # not placed
    with pytest.raises(TypeError):
        sk.sell_spmv(A, torch.zeros(got.shape[1], dtype=torch.float64))
    with pytest.raises(ValueError):
        sk.sell_spmv(A, torch.zeros(got.shape[1] + 1))


# -- (c) K5 plain version -----------------------------------------------------

@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("case", ["square48", "A1"])
def test_gs_sweep_plain_matches_reference(ref_hierarchy, case, sweep, omega,
                                          monkeypatch):
    use_interpret(monkeypatch.setattr)
    ref, got = _plans(ref_hierarchy, case)
    n = ref.shape[0]
    rng = np.random.default_rng(2)
    x, b = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    Dinv = (1.0 / np.asarray(ref.diag)).astype(np.float32)
    want = np.asarray(ref_sk.sell_gs_sweep(ref, jnp.asarray(x),
                                           jnp.asarray(b), jnp.asarray(Dinv),
                                           omega, sweep))
    before = sk.sell_gs_sweep.launches
    A = got.to("cpu")
    t = {k: torch.as_tensor(v) for k, v in (("x", x), ("b", b),
                                            ("Dinv", Dinv))}
    out = gauss_seidel(A, t["x"], t["b"], sweep=sweep, Dinv=t["Dinv"],
                       omega=omega)
    assert sk.sell_gs_sweep.launches == before
    assert np.abs(out.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    np.testing.assert_array_equal(t["x"].numpy(), x)      # x not touched


@pytest.mark.parametrize("sweep", ["forward", "backward"])
def test_gs_sweep_plain_non_finite_like_reference(ref_hierarchy, sweep,
                                                  monkeypatch):
    use_interpret(monkeypatch.setattr)
    ref, got = _plans(ref_hierarchy, "square48")
    n = ref.shape[0]
    x = _non_finite_x(n, 5)
    b = np.random.default_rng(6).standard_normal(n).astype(np.float32)
    Dinv = (1.0 / np.asarray(ref.diag)).astype(np.float32)
    want = np.asarray(ref_sk.sell_gs_sweep(ref, jnp.asarray(x), jnp.asarray(b),
                                           jnp.asarray(Dinv), 1.0, sweep))
    out = sk.sell_gs_sweep(got.to("cpu"), torch.as_tensor(x),
                           torch.as_tensor(b), torch.as_tensor(Dinv), 1.0,
                           sweep).numpy()
    assert not np.isfinite(want).all()
    _same_non_finite(out, want)


def test_gs_sweep_tile_order_matters(ref_hierarchy):
    """The three tiles of the 48^2 square are visited in order: forward
    and backward differ, and a Jacobi sweep over the whole vector (all rows
    from the entry x) differs from both."""
    _, got = _plans(ref_hierarchy, "square48")
    A = got.to("cpu")
    n = A.shape[0]
    rng = np.random.default_rng(3)
    x, b = (torch.as_tensor(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    Dinv = 1.0 / A.diag
    fwd = sk.sell_gs_sweep(A, x, b, Dinv, 1.0, "forward")
    bwd = sk.sell_gs_sweep(A, x, b, Dinv, 1.0, "backward")
    jac = x + Dinv * (b - sk.sell_spmv(A, x))
    tile = sk.GS_TILE
    # the first tile of a forward sweep, and the last of a backward one,
    # is a Jacobi step from x (to rounding: the sweep subtracts pass by
    # pass); the other tiles read updated rows
    for got, sl in ((fwd, slice(0, tile)), (bwd, slice(2 * tile, n))):
        torch.testing.assert_close(got[sl], jac[sl], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(fwd, bwd) and not torch.allclose(fwd, jac)


def test_sell_level_ignores_colors(ref_hierarchy):
    """gauss_seidel on a SELL operator runs ``iterations`` tile sweeps and
    does not read the colors it is given."""
    _, got = _plans(ref_hierarchy, "A1")
    A = got.to("cpu")
    n = A.shape[0]
    x = torch.zeros(n)
    b = torch.ones(n)
    two = gauss_seidel(A, x, b, iterations=2, colors=None, ncolors=None,
                       sweep="symmetric")
    once = sk.sell_gs_sweep(A, x, b, 1.0 / A.diag, 1.0, "symmetric")
    again = sk.sell_gs_sweep(A, once, b, 1.0 / A.diag, 1.0, "symmetric")
    assert torch.equal(two, again)


def test_placed_plan_keeps_the_host_plan(ref_hierarchy):
    _, got = _plans(ref_hierarchy, "R0")
    A = got.to("cpu")
    assert A.bases_t.dtype == torch.int32
    assert A.bases_t.tolist() == list(got.bases)
    assert torch.equal(A.vals, torch.as_tensor(got.vals))
    assert torch.equal(A.delta, torch.as_tensor(got.delta))
    assert A.bases == got.bases and got.bases_t is None


@pytest.mark.parametrize("case", ["square48", "tall", "fat", "R0"])
def test_placed_plan_knows_its_zero_slots(ref_hierarchy, case):
    """The padded slots hold value 0 and delta 0, so a placed plan may skip
    the delta read of a slot holding 0; a slot holding 0 with another
    delta turns that off."""
    _, got = _plans(ref_hierarchy, case)
    assert got.to("cpu").zero_delta0
    vals = np.array(got.vals)
    delta = np.array(got.delta)
    p, s, l = np.argwhere(vals != 0)[0]
    vals[p, s, l] = 0
    delta[p, s, l] = 1
    odd = dataclasses.replace(got, vals=vals, delta=delta).to("cpu")
    assert not odd.zero_delta0


def test_dense_of_a_sell_level(ref_hierarchy):
    """collapse_coarse densifies a SELL level as its ELL original."""
    from pyamg_tpu_torch.ops.dense import to_dense
    ref_ell, ell = _pair(_operators(ref_hierarchy)["A1"])
    got = to_dense(sell_from_ell(ell), device="cpu")
    assert torch.equal(got, to_dense(ell, device="cpu"))
