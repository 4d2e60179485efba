"""The port's solve phase against the JAX package's, on the CPU.

* ``ops/ds.py``: the double-single transforms against float64 gold, as
  ``tests/test_ds.py`` holds the reference's.
* ``cg_loop``: the same preconditioned CG as the reference, iterate for
  iterate (float64 rtol 1e-10), and the same stall exit in float32
  (rtol 1e-3).
* ``solve_refined_device`` on 2-D Poisson 96^2 with the coarse tail
  collapsed at n <= 600 (3 active levels, like the 500^2 main path): once
  with the port's own setup, once with the reference's hierarchy carried
  over by ``hierarchy_from_arrays``.  Equal outer counts, inner counts
  within 1, true residuals below 1e-10, and x within 1e-8 relative of the
  reference's (both are refined to 1e-10; x differs by float32 rounding of
  the inner solves, far below that).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.krylov.methods import cg_loop as ref_cg_loop
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.krylov.methods import cg_loop
from pyamg_tpu_torch.ops import ds
from pyamg_tpu_torch.sparse.matrix import dia_from_ell, from_scipy, to_scipy

torch.set_num_threads(1)


def _f32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def _f64(t):
    return t.numpy().astype(np.float64)


# -- double-single arithmetic ------------------------------------------------

def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-6).astype(np.float32)
    s, e = ds.two_sum(_f32(a), _f32(b))
    np.testing.assert_array_equal(_f64(s) + _f64(e),
                                  a.astype(np.float64) + b.astype(np.float64))


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = ds.two_prod(_f32(a), _f32(b))
    np.testing.assert_array_equal(_f64(p) + _f64(e),
                                  a.astype(np.float64) * b.astype(np.float64))


def test_ds_roundtrip_f64():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000) * 5)
    hi, lo = ds.ds_from_f64(x)
    back = ds.ds_to_f64(_f32(hi), _f32(lo))
    assert np.max(np.abs(back - x) / np.abs(x)) < 2.0 ** -47


def test_ds_add_and_mul_accuracy():
    rng = np.random.default_rng(3)
    x = rng.standard_normal(500)
    y = rng.standard_normal(500) * 1e-8
    xhi, xlo = map(_f32, ds.ds_from_f64(x))
    yhi, ylo = map(_f32, ds.ds_from_f64(y))
    got = ds.ds_to_f64(*ds.ds_add(xhi, xlo, yhi, ylo))
    assert np.max(np.abs(got - (x + y)) / np.abs(x + y)) < 2.0 ** -45
    c = np.float32(1.2345678)
    got = ds.ds_to_f64(*ds.ds_mul_f32(xhi, xlo, c))
    exact = x * np.float64(c)
    assert np.max(np.abs(got - exact) / np.abs(exact)) < 2.0 ** -45


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_ds_residual_matches_f64(kind):
    """b - A x in double-single equals the float64 residual to 1e-12 of
    ||b|| although the residual is 1e-9 of b (deep cancellation)."""
    A64 = poisson((40, 40))
    As = to_scipy(A64)
    rng = np.random.default_rng(4)
    xstar = rng.standard_normal(As.shape[0])
    b = As @ xstar
    x = xstar * (1.0 + 1e-9 * rng.standard_normal(As.shape[0]))
    r64 = b - As @ x
    A_ds = ds.ds_operator(dia_from_ell(A64) if kind == "dia"
                          else from_scipy(As), kind=kind, device="cpu")
    assert A_ds["kind"] == kind
    xhi, xlo = map(_f32, ds.ds_from_f64(x))
    bhi, blo = map(_f32, ds.ds_from_f64(b))
    got = ds.ds_to_f64(*ds.ds_residual(A_ds, xhi, xlo, bhi, blo))
    assert np.linalg.norm(got - r64) < 1e-12 * np.linalg.norm(b)
    assert abs(np.linalg.norm(got) - np.linalg.norm(r64)) \
        < 1e-6 * np.linalg.norm(r64)


# -- preconditioned CG ---------------------------------------------------------

@pytest.mark.parametrize("dtype, tol, criteria", [
    (np.float64, 1e-8, "rr"), (np.float64, 1e-8, "rr+"),
    (np.float64, 1e-8, "MrMr"), (np.float64, 1e-8, "rMr"),
    (np.float32, 1e-12, "rr")])
def test_cg_loop_matches_reference(dtype, tol, criteria):
    """Jacobi-preconditioned CG on 2-D Poisson 24^2, under each stopping
    criterion.  In float32 the tight tolerance ends the loop by the stall
    test, with the best iterate."""
    S = to_scipy(poisson((24, 24))).astype(dtype)
    n = S.shape[0]
    dinv = (1.0 / S.diagonal()).astype(dtype)
    b = np.random.default_rng(5).standard_normal(n).astype(dtype)
    Sj, dj = jnp.asarray(S.toarray()), jnp.asarray(dinv)
    ref = ref_cg_loop(lambda v: Sj @ v, lambda r: dj * r,
                      jnp.zeros(n, dtype), jnp.asarray(b), tol, criteria, 200)
    St, dt = torch.as_tensor(S.toarray()), torch.as_tensor(dinv)
    got = cg_loop(lambda v: St @ v, lambda r: dt * r,
                  torch.zeros(n, dtype=St.dtype), torch.as_tensor(b), tol,
                  criteria, 200)
    nres = int(ref[3])
    assert got[3] == nres and int(got[1]) == int(ref[1])
    rres = np.asarray(ref[2])[:nres]
    # in float32 the two libraries' products round differently and CG
    # carries the difference on (0.04% after 50 iterations), and residuals
    # near the rounding floor are noise: compare the history while it is
    # above 1e-4 of its start, to 1e-3
    keep = rres > (0 if dtype == np.float64 else 1e-4 * rres[0])
    rtol = 1e-10 if dtype == np.float64 else 1e-3
    np.testing.assert_allclose(got[2][:nres].numpy()[keep], rres[keep],
                               rtol=rtol, atol=rtol * rres[0])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=rtol, atol=rtol * np.abs(ref[0]).max())
    if dtype == np.float32:
        assert nres - 1 < 200           # stopped by the stall test


# -- the refined solve ---------------------------------------------------------

N = 96


def _ref_hierarchy():
    A64 = ref_poisson((N, N))
    ml = ref_sa(A64.astype(jnp.float32), aggregate=("grid", {}),
                max_coarse=10)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=600)
    ml.enable_ds_refinement(A64)
    return A64, ml


def _ref_orders(ml, monkeypatch):
    """The color-pass order the reference sweeps, per level and smoother:
    recorded where ``gauss_seidel`` hands it to the fused DIA sweep (made
    to decline, so the trace goes on through the jnp loop)."""
    import pyamg_tpu.ops.pallas_kernels as pk
    from pyamg_tpu.relaxation.smoothing import apply_smoother
    seen = []
    monkeypatch.setattr(pk, "pallas_available", lambda: True)
    monkeypatch.setattr(pk, "dia_spmv_pallas", lambda A, x: None)
    monkeypatch.setattr(pk, "dia_gs_sweep",
                        lambda *a, **k: seen.append(list(a[5])))
    orders = []
    for lvl in ml.levels[:-1]:
        n = lvl.A.shape[0]
        sds = jax.ShapeDtypeStruct((n,), jnp.float32)
        pair = []
        for kind, sopts, params in (lvl.pre, lvl.post):
            jax.eval_shape(lambda x, b: apply_smoother(
                kind, sopts, params, lvl.A, x, b), sds, sds)
            pair.append(seen.pop())
        orders.append(pair)
    return orders


def _spec(ml, orders):
    """The reference hierarchy as the plain arrays of
    ``hierarchy_from_arrays``."""
    def phase(op):
        return {"arrays": [np.asarray(a) for a in op.arrays],
                "offsets": op.offsets, "row_grid": op.row_grid,
                "col_grid": op.col_grid, "ratio": op.ratio,
                "trans": op.trans, "nnz": op.nnz}

    def smoother(sm, order):
        kind, sopts, params = sm
        return {"kind": kind, "opts": dict(sopts), "order": order,
                "colors": np.asarray(params["colors"]),
                "Dinv": np.asarray(params["Dinv"])}

    levels = []
    for i, lvl in enumerate(ml.levels):
        d = {"A": {"data": np.asarray(lvl.A.data),
                   "offsets": lvl.A.offsets, "shape": lvl.A.shape}}
        if i < len(ml.levels) - 1:
            d.update(P=phase(lvl.P), R=phase(lvl.R),
                     pre=smoother(lvl.pre, orders[i][0]),
                     post=smoother(lvl.post, orders[i][1]))
        levels.append(d)
    return {"levels": levels,
            "coarse": {"kind": "pinv",
                       "op": np.asarray(ml.coarse_solver.params["op"])},
            "ds": {k: (np.asarray(v) if hasattr(v, "shape") else v)
                   for k, v in ml._ds_op.items()}}


@pytest.fixture(scope="module")
def reference_solve():
    A64, ml = _ref_hierarchy()
    b = np.random.default_rng(2022).standard_normal(A64.shape[0])
    it = {}
    x = ml.solve_refined_device(b, tol=1e-10, iterations_out=it)
    return A64, ml, b, x, it


def _check_against_reference(x, it, reference_solve):
    A64, _, b, xr, itr = reference_solve
    As = ref_to_scipy(A64)
    for v in (x, xr):
        assert np.linalg.norm(b - As @ v) / np.linalg.norm(b) < 1e-10
    assert it["outer"] == itr["outer"]
    assert abs(it["inner"] - itr["inner"]) <= 1
    assert np.linalg.norm(x - xr) / np.linalg.norm(xr) < 1e-8


def test_solve_refined_device_own_setup(reference_solve):
    A64 = poisson((N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=600, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    assert len(ml.levels) == 3
    it, res = {}, []
    x = ml.solve_refined_device(np.random.default_rng(2022).standard_normal(
        A64.shape[0]), tol=1e-10, residuals=res, iterations_out=it)
    assert len(res) == it["outer"] + 1 and res[-1] < res[0]
    _check_against_reference(x, it, reference_solve)


def test_solve_refined_device_from_reference_arrays(reference_solve,
                                                    monkeypatch):
    _, ml_ref, b, _, _ = reference_solve
    spec = _spec(ml_ref, _ref_orders(ml_ref, monkeypatch))
    ml = hierarchy_from_arrays(spec, device="cpu")
    it = {}
    x = ml.solve_refined_device(b, tol=1e-10, iterations_out=it)
    _check_against_reference(x, it, reference_solve)


def test_hierarchy_from_arrays_rejects_another_order(reference_solve,
                                                     monkeypatch):
    _, ml_ref, _, _, _ = reference_solve
    spec = _spec(ml_ref, _ref_orders(ml_ref, monkeypatch))
    spec["levels"][0]["pre"]["order"] = [0, 1, 1, 0]
    with pytest.raises(ValueError):
        hierarchy_from_arrays(spec, device="cpu")


def test_uncompressed_levels_solve_alike():
    """Levels left as ELL (no DIA, no SELL) take the tensor ELL product
    and the generic color loop, and the dense tail is built from an ELL:
    the same solve as the DIA path, to float32 rounding."""
    A64 = poisson((48, 48))
    b = np.random.default_rng(7).standard_normal(A64.shape[0])
    out = []
    for max_diags in (64, 1):
        ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                         aggregate=("grid", {}),
                                         max_coarse=10)
        ml.compress_stencils(max_diags=max_diags, sell=False)
        ml.collapse_coarse(max_n=200, device="cpu")
        ml.enable_ds_refinement(A64, device="cpu").to_device("cpu")
        it = {}
        out.append((ml.solve_refined_device(b, iterations_out=it), it,
                    type(ml.levels[0].A).__name__))
    (x1, it1, k1), (x2, it2, k2) = out
    assert (k1, k2) == ("DIA", "ELL") and it1["outer"] == it2["outer"]
    assert abs(it1["inner"] - it2["inner"]) <= 1
    assert np.linalg.norm(x1 - x2) / np.linalg.norm(x1) < 1e-8


def test_converged_rhs_runs_no_inner_solve():
    A64 = poisson((32, 32))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils().enable_ds_refinement(A64, device="cpu")
    it = {}
    x = ml.to_device("cpu").solve_refined_device(np.zeros(A64.shape[0]),
                                                 iterations_out=it)
    assert it == {"outer": 0, "inner": 0} and np.all(x == 0)
