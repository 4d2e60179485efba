"""The port's standard-aggregation SA path on 3-D Poisson against the JAX
package's, on the CPU.

This is the flow of ``bench_suite.bench_sa_poisson_3d_64`` at 24^3:
standard SA with ``max_coarse=50``, ``compress_stencils`` (DIA, and SELL
for the other operators), then ``solve_refined(tol=1e-10, accel="cg")``.
The JAX package builds its SELL levels and runs its SELL kernels in
interpret mode (``jax_sell_reference``); the port runs the plain versions
of its kernels because its tensors lie on the CPU.

Tolerances: aggregates and sparsity patterns equal; A/P/R values to rtol
1e-6 (float32 setup arithmetic on both sides); one V-cycle to 1e-5 of
max |x| (float32 products rounded in other orders by the two libraries);
inner CG counts equal, residuals to 1e-4 relative (CG carries rounding
differences on); refined x to 1e-6 relative (both are refined to a true
relative residual below 1e-10).
"""

import inspect

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.aggregation.aggregate import \
    standard_aggregation as ref_standard_aggregation
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy
from pyamg_tpu.strength import symmetric_strength_of_connection as ref_soc

from jax_sell_reference import (dia_orders, layouts, record_inner, sellify,
                                use_interpret)

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.aggregation.aggregate import standard_aggregation
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.multilevel import MultilevelSolver
from pyamg_tpu_torch.sparse.matrix import ELL, from_scipy, to_scipy
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.strength import symmetric_strength_of_connection

torch.set_num_threads(1)

N = 24
LAYOUTS = [("DIA", "SELL", "SELL"), ("SELL", "SELL", "ELL"),
           ("SELL", "NoneType", "NoneType")]


def _b():
    return np.random.default_rng(0).standard_normal(N ** 3)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's hierarchy with SELL levels, its refined solve and
    its inner CG counts (kernels in interpret mode for the module)."""
    with pytest.MonkeyPatch.context() as mp:
        use_interpret(mp.setattr)
        A64 = ref_poisson((N, N, N))
        ml = ref_sa(A64.astype(jnp.float32), max_coarse=50)
        uncompressed = [(l.A, getattr(l, "P", None), getattr(l, "R", None))
                        for l in ml.levels]
        sellify(ml)
        inner = record_inner(ml)
        x = ml.solve_refined(_b(), A_fine=ref_to_scipy(A64), tol=1e-10,
                             accel="cg")
        del ml.solve
        yield {"A64": ref_to_scipy(A64), "ml": ml, "x": np.asarray(x),
               "inner": list(inner), "uncompressed": uncompressed}


@pytest.fixture(scope="module")
def port():
    A64 = poisson((N, N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32), max_coarse=50)
    uncompressed = [(l.A, l.P, l.R) for l in ml.levels]
    ml.compress_stencils().to_device("cpu")
    return {"A64": to_scipy(A64), "ml": ml, "uncompressed": uncompressed}


def _same_ell(got, want):
    assert isinstance(got, ELL) and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.row_nnz, np.asarray(want.row_nnz))
    mask = got.valid_mask()
    np.testing.assert_array_equal(got.cols[mask], np.asarray(want.cols)[mask])
    np.testing.assert_allclose(got.vals[mask], np.asarray(want.vals)[mask],
                               rtol=1e-6, atol=0)


# -- (d) standard aggregation -------------------------------------------------

def _isolated_poisson():
    """2-D Poisson 20^2 with node 0 decoupled (an isolated node)."""
    A = to_scipy(poisson((20, 20))).tolil()
    A[0, 1:] = 0
    A[1:, 0] = 0
    A = A.tocsr()
    A.eliminate_zeros()
    return A


@pytest.mark.parametrize("case", ["poisson3d", "poisson2d", "isolated"])
def test_standard_aggregation_matches_reference(case):
    S = {"poisson3d": lambda: to_scipy(poisson((N, N, N))),
         "poisson2d": lambda: to_scipy(poisson((40, 40))),
         "isolated": _isolated_poisson}[case]()
    C = symmetric_strength_of_connection(from_scipy(S))
    Cr = ref_soc(ref_from_scipy(S))
    _same_ell(C, Cr)
    agg, cpts = standard_aggregation(C)
    ragg, rcpts = ref_standard_aggregation(Cr)
    assert agg.shape == tuple(ragg.shape)
    np.testing.assert_array_equal(agg.row_nnz, np.asarray(ragg.row_nnz))
    np.testing.assert_array_equal(agg.cols, np.asarray(ragg.cols))
    np.testing.assert_array_equal(cpts, np.asarray(rcpts))
    if case == "isolated":
        assert agg.row_nnz[0] == 0


def test_parallel_standard_aggregation_is_not_ported():
    """Ported since: the parallel form (MIS-2 seeds and label propagation)
    aggregates as the JAX package's does."""
    S = to_scipy(poisson((8, 8)))
    C = symmetric_strength_of_connection(from_scipy(S))
    agg, roots = standard_aggregation(C, method="parallel")
    ragg, rroots = ref_standard_aggregation(ref_soc(ref_from_scipy(S)),
                                            method="parallel")
    np.testing.assert_array_equal(agg.cols, np.asarray(ragg.cols))
    np.testing.assert_array_equal(agg.row_nnz, np.asarray(ragg.row_nnz))
    np.testing.assert_array_equal(roots, np.asarray(rroots))


# -- (e) the hierarchy --------------------------------------------------------

def test_hierarchy_matches_reference(ref, port):
    mr, mp = ref["ml"], port["ml"]
    assert len(mp.levels) == len(mr.levels) == 3
    assert [l.A.shape for l in mp.levels] == \
        [tuple(l.A.shape) for l in mr.levels]
    assert [l.A.nnz for l in mp.levels] == [l.A.nnz for l in mr.levels]
    assert abs(mp.operator_complexity() - mr.operator_complexity()) < 1e-12
    for got, want in zip(port["uncompressed"], ref["uncompressed"]):
        for g, w in zip(got, want):
            if w is not None:
                _same_ell(g, w)


def test_layouts_match_reference(ref, port):
    mp = port["ml"]
    assert layouts(ref["ml"]) == layouts(mp) == LAYOUTS
    for lp, lr in zip(mp.levels, ref["ml"].levels):
        for attr in "APR":
            g, w = getattr(lp, attr), getattr(lr, attr, None)
            if isinstance(w, type(None)) or type(w).__name__ != "SELL":
                continue
            assert isinstance(g, SELL) and g.bases == w.bases
            np.testing.assert_allclose(g.vals.numpy(), np.asarray(w.vals),
                                       rtol=1e-6, atol=0)
            np.testing.assert_array_equal(g.delta.numpy(),
                                          np.asarray(w.delta))
            assert isinstance(getattr(lp, attr + "_ell"), ELL)


# -- (f) one V-cycle ----------------------------------------------------------

def _spec(ml, orders):
    """The JAX package's hierarchy as the arrays of
    ``hierarchy_from_arrays``."""
    def op(o):
        kind = type(o).__name__
        if kind == "DIA":
            return {"data": np.asarray(o.data), "offsets": o.offsets,
                    "shape": o.shape}
        if kind == "SELL":
            return {"vals": np.asarray(o.vals), "delta": np.asarray(o.delta),
                    "bases": o.bases, "diag": np.asarray(o.diag),
                    "shape": o.shape, "t": o.t, "kind": o.kind, "K": o.K,
                    "pad_top": o.pad_top, "x_rows": o.x_rows, "nnz": o.nnz,
                    "base_lo": o.base_lo, "base_hi": o.base_hi}
        return {"cols": np.asarray(o.cols), "vals": np.asarray(o.vals),
                "row_nnz": np.asarray(o.row_nnz), "shape": o.shape}

    def smoother(sm, order):
        kind, sopts, params = sm
        d = {"kind": kind, "opts": dict(sopts),
             "Dinv": np.asarray(params["Dinv"]),
             "colors": np.asarray(params["colors"])}
        if order is not None:
            d["order"] = order
        return d

    levels = []
    for i, lvl in enumerate(ml.levels):
        d = {"A": op(lvl.A)}
        if i < len(ml.levels) - 1:
            pre, post = orders.get(i, (None, None))
            d.update(P=op(lvl.P), R=op(lvl.R), pre=smoother(lvl.pre, pre),
                     post=smoother(lvl.post, post))
        levels.append(d)
    return {"levels": levels,
            "coarse": {"kind": "pinv",
                       "op": np.asarray(ml.coarse_solver.params["op"])}}


@pytest.fixture(scope="module")
def from_ref(ref):
    with pytest.MonkeyPatch.context() as mp:
        orders = dia_orders(ref["ml"], mp.setattr)
    return hierarchy_from_arrays(_spec(ref["ml"], orders), device="cpu")


@pytest.mark.parametrize("source", ["own_setup", "from_reference_arrays"])
def test_vcycle_matches_reference(ref, port, from_ref, source, monkeypatch):
    use_interpret(monkeypatch.setattr)
    ml = port["ml"] if source == "own_setup" else from_ref
    assert layouts(ml) == LAYOUTS
    rng = np.random.default_rng(4)
    x = rng.standard_normal(N ** 3).astype(np.float32)
    b = rng.standard_normal(N ** 3).astype(np.float32)
    mr = ref["ml"]
    want = np.asarray(jax.jit(mr._make_cycle("V"))(mr._dyn(), jnp.asarray(x),
                                                   jnp.asarray(b)))
    got = ml._make_cycle("V")(torch.as_tensor(x), torch.as_tensor(b))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# -- (g) the inner CG solve ---------------------------------------------------

@pytest.mark.parametrize("source", ["own_setup", "from_reference_arrays"])
def test_inner_cg_matches_reference(ref, port, from_ref, source,
                                    monkeypatch):
    use_interpret(monkeypatch.setattr)
    ml = port["ml"] if source == "own_setup" else from_ref
    b = _b().astype(np.float32)
    want_res, got_res = [], []
    want = ref["ml"].solve(jnp.asarray(b), tol=1e-5, maxiter=30, accel="cg",
                           residuals=want_res)
    got, info = ml.solve(b, tol=1e-5, maxiter=30, accel="cg",
                         residuals=got_res, return_info=True)
    assert info == 0 and len(got_res) == len(want_res)
    np.testing.assert_allclose(got_res, want_res, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


# -- (h) the refined solve ----------------------------------------------------

@pytest.mark.parametrize("source", ["own_setup", "from_reference_arrays"])
def test_solve_refined_matches_reference(ref, port, from_ref, source):
    ml = port["ml"] if source == "own_setup" else from_ref
    A, b = ref["A64"], _b()
    it, hist = {}, []
    x = ml.solve_refined(b, A_fine=A, tol=1e-10, residuals=hist,
                         iterations_out=it)
    xr = ref["x"]
    for v in (x, xr):
        assert np.linalg.norm(b - A @ v) / np.linalg.norm(b) < 1e-10
    assert it["outer"] == len(ref["inner"]) == len(hist) - 1 == 2
    assert it["inner"] == ref["inner"]
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-6


def test_solve_refined_escalates_to_float64(port):
    """A stalled outer step moves the inner solves to the float64 twin,
    whose SELL levels are their ELL originals; a second stall stops with a
    warning.  The twin alone solves to 1e-10."""
    ml = port["ml"]
    A, b = port["A64"], _b()
    with pytest.warns(UserWarning, match="stalled"):
        ml.solve_refined(b, A_fine=A, inner_maxiter=0)
    twin = ml._f64_twin
    assert layouts(twin) == [("DIA", "ELL", "ELL"), ("ELL", "ELL", "ELL"),
                             ("ELL", "NoneType", "NoneType")]
    assert twin.levels[0].A.dtype == twin.levels[1].A.dtype == torch.float64
    assert twin.levels[1].pre[2]["Dinv"].dtype == torch.float64
    it = {}
    x = twin.solve_refined(b, A_fine=A, tol=1e-10, iterations_out=it)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-10
    assert it["outer"] == 2


# -- (i) solve: standalone cycling and the callback ---------------------------

def test_standalone_solve_matches_reference(ref, port, monkeypatch):
    use_interpret(monkeypatch.setattr)
    b = _b().astype(np.float32)
    want_res, got_res = [], []
    # tol 1e-4 keeps every residual well above float32's rounding floor,
    # where the two libraries' iterates part
    want = ref["ml"].solve(jnp.asarray(b), tol=1e-4, maxiter=15,
                           residuals=want_res)
    got = port["ml"].solve(b, tol=1e-4, maxiter=15, residuals=got_res)
    assert len(got_res) == len(want_res) == 7
    np.testing.assert_allclose(got_res, want_res, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("accel", [None, "cg"])
def test_solve_callback_matches_the_plain_path(port, accel):
    ml = port["ml"]
    b = _b().astype(np.float32)
    plain_res, cb_res, seen = [], [], []
    x, info = ml.solve(b, tol=1e-7, maxiter=12, accel=accel,
                       residuals=plain_res, return_info=True)
    y, info_cb = ml.solve(b, tol=1e-7, maxiter=12, accel=accel,
                          callback=lambda v: seen.append(v.clone()),
                          residuals=cb_res, return_info=True)
    assert torch.equal(x, y) and info == info_cb
    assert cb_res == plain_res and len(seen) == len(plain_res) - 1
    if accel is None:
        assert torch.equal(seen[-1], y)
        r = torch.as_tensor(b) - ml.levels[0].A.mv(seen[0])
        assert abs(float(torch.linalg.vector_norm(r)) - cb_res[1]) \
            <= 1e-6 * cb_res[1]


def test_gmres_is_not_ported(ref, port, monkeypatch):
    """GMRES is ported now: ``solve(accel="gmres")`` on the SELL hierarchy
    takes the JAX package's steps, with its preconditioned residuals to
    1e-4 relative and x to 1e-4 of max |x| (float32; tol 1e-4 keeps the
    residuals above the rounding floor, as in the standalone test)."""
    use_interpret(monkeypatch.setattr)
    b = _b().astype(np.float32)
    want_res, got_res = [], []
    want, want_info = ref["ml"].solve(jnp.asarray(b), tol=1e-4, maxiter=20,
                                      accel="gmres", residuals=want_res,
                                      return_info=True)
    got, info = port["ml"].solve(b, tol=1e-4, maxiter=20, accel="gmres",
                                 residuals=got_res, return_info=True)
    assert info == want_info == 0 and len(got_res) == len(want_res) > 2
    np.testing.assert_allclose(got_res, want_res, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_aspreconditioner_is_one_cycle(port):
    ml = port["ml"]
    M = ml.aspreconditioner()
    r = torch.as_tensor(_b().astype(np.float32))
    assert M.shape == (N ** 3, N ** 3) and M.dtype == torch.float32
    assert torch.equal(M @ r, ml._make_cycle("V")(torch.zeros_like(r), r))
    assert torch.equal(M.matvec(r), M @ r)


def test_solve_signatures_follow_the_reference():
    from pyamg_tpu.multilevel import MultilevelSolver as Ref
    for name in ("solve_refined", "aspreconditioner"):
        ref_params = list(inspect.signature(getattr(Ref, name)).parameters)
        got = list(inspect.signature(getattr(MultilevelSolver,
                                             name)).parameters)
        assert got[:len(ref_params)] == ref_params
    ref_solve = inspect.signature(Ref.solve).parameters
    got_solve = inspect.signature(MultilevelSolver.solve).parameters
    assert list(ref_solve) == list(got_solve)
