"""The JAX package's 10M-unknown single-chip flows, held on the CPU at
small sizes: the port against the JAX package, both run in this process
from the same numpy inputs.

* ``benchmarks/bench_10m_solve.py``'s main path (2-D Poisson N^2, grid SA
  of its float32 copy with ``max_coarse=10``, ``compress_stencils``,
  ``collapse_coarse(4096)``, ``enable_ds_refinement``,
  ``solve_refined_device(tol=1e-10, inner_tol=1e-5, inner_maxiter=40,
  max_outer=10)``, b from ``default_rng(2022)``) at 49^2 and 193^2, N mod
  3 = 1 as 3163 is: the levels before and after the collapse, rows,
  operator complexity within 1e-6, layouts and DIA widths equal; the
  outer and inner iterations equal; x within 1e-6 relative.  The rows
  before the collapse follow the grid rule ``chip_smoke.grid_rows``,
  which the card's ``scale:`` phase holds the 3163^2 hierarchy to.
* The port's solve of the JAX package's 193^2 hierarchy, carried over by
  ``hierarchy_from_arrays``: the same iterations, x within 1e-6.
* ``benchmarks/bench_sell_scale.py``'s plan, ``sell_from_ell(A,
  k_choices=(4,))``, at 1228^2, the smallest 2-D Poisson whose plan is in
  the K4 regime (x past the TPU's 6 MiB budget; 1227^2's is not): the two
  packages' plans equal field for field, and one product of the port's
  (its plain version, the tensors lie on the CPU) against scipy's.

``tests/jax_scale_reference.py --small`` prints the JAX package's side.
"""

import importlib.util
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.sparse.sell import sell_from_ell as ref_sell_from_ell

from pyamg_tpu_torch import hierarchy_from_arrays
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.ops import sell_kernels as sk
from pyamg_tpu_torch.sparse import sell as sellm
from pyamg_tpu_torch.sparse.matrix import to_scipy

from jax_scale_reference import describe, flow
from test_torch_sell import PLAN_FIELDS
from test_torch_solve import _ref_orders, _spec

torch.set_num_threads(1)

SIZES = [49, 193]
K4_N = 1228
SOLVE = dict(tol=1e-10, inner_tol=1e-5, inner_maxiter=40, max_outer=10)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_flow(N):
    A64 = poisson((N, N))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    before = [int(lvl.A.shape[0]) for lvl in ml.levels]
    oc = ml.operator_complexity()
    ml.compress_stencils()
    ml.collapse_coarse(max_n=4096, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    b = np.random.default_rng(2022).standard_normal(A64.shape[0])
    it = {}
    x = ml.solve_refined_device(b, iterations_out=it, **SOLVE)
    return {**describe(ml), "rows_before": before,
            "operator_complexity": oc, "iterations": it, "x": x,
            "true_relres": float(np.linalg.norm(b - to_scipy(A64) @ x) /
                                 np.linalg.norm(b))}


@pytest.fixture(scope="module")
def flows():
    """{N: (the JAX package's flow, the port's flow)}, made on first use."""
    cache = {}

    def get(N):
        if N not in cache:
            cache[N] = (flow(N, keep=True), _port_flow(N))
        return cache[N]
    return get


@pytest.mark.parametrize("N", SIZES)
def test_hierarchy_matches_the_jax_package(flows, N):
    ref, got = flows(N)
    assert got["rows_before"] == ref["rows_before"]
    assert got["rows"] == ref["rows"]
    assert abs(got["operator_complexity"] - ref["operator_complexity"]) \
        <= 1e-6
    assert got["layouts"] == ref["layouts"]
    assert got["dia"] == ref["dia"]


@pytest.mark.parametrize("N", SIZES)
def test_rows_follow_the_grid_rule(flows, N):
    ref, _ = flows(N)
    assert _chip_smoke().grid_rows(N) == ref["rows_before"]


@pytest.mark.parametrize("N", SIZES)
def test_iterations_match_the_jax_package(flows, N):
    ref, got = flows(N)
    assert got["iterations"] == {"outer": ref["outer"],
                                 "inner": ref["inner"]}


@pytest.mark.parametrize("N", SIZES)
def test_solution_matches_the_jax_package(flows, N):
    ref, got = flows(N)
    assert ref["true_relres"] < 1e-10 and got["true_relres"] < 1e-10
    xr = ref["x"]
    assert np.linalg.norm(got["x"] - xr) / np.linalg.norm(xr) < 1e-6


def test_port_solves_the_jax_hierarchy(flows, monkeypatch):
    ref, _ = flows(SIZES[-1])
    ml_ref = ref["ml"]
    ml = hierarchy_from_arrays(_spec(ml_ref, _ref_orders(ml_ref,
                                                         monkeypatch)),
                               device="cpu")
    it = {}
    x = ml.solve_refined_device(ref["b"], iterations_out=it, **SOLVE)
    assert it == {"outer": ref["outer"], "inner": ref["inner"]}
    assert np.linalg.norm(x - ref["x"]) / np.linalg.norm(ref["x"]) < 1e-6


@pytest.fixture(scope="module")
def k4_plans():
    """The two packages' k_choices=(4,) plans at K4_N^2 and K4_N - 1."""
    out = {}
    for N in (K4_N - 1, K4_N):
        ref = ref_sell_from_ell(ref_poisson((N, N)).astype(jnp.float32),
                                k_choices=(4,))
        got = sellm.sell_from_ell(poisson((N, N)).astype(np.float32),
                                  k_choices=(4,))
        out[N] = (ref, got)
    return out


def _k4_regime(plan):
    return plan.x_rows * sellm.LANE * 4 > sellm._VMEM_X_BUDGET


def test_k4_plan_regime(k4_plans):
    """1228^2 is the smallest 2-D Poisson whose plan takes the tiled
    kernel; both packages agree on the boundary."""
    for N, (ref, got) in k4_plans.items():
        assert got.square and ref.kind == got.kind == "tall" and got.t == 1
        assert _k4_regime(got) == _k4_regime(ref) == (N == K4_N)


@pytest.mark.parametrize("field", PLAN_FIELDS)
def test_k4_plan_matches_the_jax_package(k4_plans, field):
    ref, got = k4_plans[K4_N]
    a, b = getattr(ref, field), getattr(got, field)
    if field in ("vals", "delta", "diag"):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    else:
        assert b == a


def test_k4_plan_product(k4_plans):
    _, got = k4_plans[K4_N]
    S = got.to("cpu")
    x = np.random.default_rng(0).standard_normal(got.shape[1]).astype(
        np.float32)
    y = sk.sell_spmv(S, torch.as_tensor(x)).numpy()
    want = to_scipy(poisson((K4_N, K4_N))).astype(np.float32) @ x
    assert np.abs(y - want).max() <= 1e-6 * np.abs(want).max()
