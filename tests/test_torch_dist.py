"""The row-sharded solve across 4 processes (gloo on the CPU) against the
JAX package on a 4-device mesh.

The module starts the 4 ranks once (``tests/torch_dist_worker.py``, which
imports only the port) and every test reads their results: the dryrun's
three 32^2 flows (``__graft_entry__.dryrun_multichip``), the halo CG to
1e-8, and ``tests/test_halo.py``'s 24^2 standalone and 20^2 CG solves,
whose level 1 pads (102 and 70 rows over 4 ranks).  The JAX package's
histories come from ``jax_parallel_reference`` on ``make_row_mesh(4)``
over the conftest's virtual devices, in this process.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import jax_parallel_reference as jref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WORLD = 4
DEADLINE_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: the 4 processes run once for the module, and
    any still running at the deadline is killed (the tests then fail)."""
    out = tmp_path_factory.mktemp("torch_dist")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    end = time.monotonic() + DEADLINE_S
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(
                timeout=max(1.0, end - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            logs.append(p.communicate()[0])
            pytest.fail(f"a rank outlived the {DEADLINE_S} s deadline: "
                        f"{logs[-1][-2000:]}")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    results = []
    for r in range(WORLD):
        with open(out / f"rank{r}.json") as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def ref():
    out = jref.flows(*jref.DRYRUN_ARGS, ndev=WORLD)
    out.update(jref.halo_cases(ndev=WORLD))
    return out


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=0)


def _close_history(got, want, rtol):
    """A residual history within ``rtol`` of ``want``'s largest entry (its
    first): a solve run to 1e-10 ends where rounding sets the last digits,
    so entry by entry the last ones differ at 1e-7 of themselves."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, got, want)


@pytest.mark.parametrize("flow", ["cg3", "sa2", "halo2"])
def test_dryrun_flows_match_the_jax_mesh(ranks, ref, flow):
    """The dryrun's three flows: the residual history of every rank to
    1e-10 of the JAX package's on its 4-device mesh."""
    for res in ranks:
        assert len(res[flow][0]) == len(ref[flow])
        _close(res[flow][0], ref[flow], 1e-10)


def test_cg3_x_matches_the_unsharded_port(ranks):
    """x of the sharded CG equals the unsharded port's, on every rank."""
    from torch_dist_worker import build
    A, ml = build(32, 8)
    b = np.random.default_rng(0).standard_normal(A.shape[0])
    x = ml.to_device("cpu").solve(b, maxiter=3, tol=1e-12, accel="cg")
    for res in ranks:
        np.testing.assert_allclose(res["cg3"][1], x.numpy(), rtol=1e-8,
                                   atol=1e-12)


def test_halo_cg_to_1e8(ranks, ref):
    """The halo CG takes the JAX package's 7 iterations to 1e-8 and its
    true relative residual is below 1e-8."""
    for res in ranks:
        assert len(res["halo_cg"][0]) - 1 == ref["halo_cg_iters"] == 7
        assert res["halo_cg_relres"] < 1e-8
        _close(res["halo_cg"][0], ranks[0]["halo_cg"][0], 0)


@pytest.mark.parametrize("case", ["halo24", "halo20cg"])
def test_halo_hierarchy_solves_match_the_jax_mesh(ranks, ref, case):
    """``tests/test_halo.py``'s 24^2 standalone (maxiter 8) and 20^2 CG to
    1e-10, whose level 1 pads: histories to 1e-10 of their first entry, x
    to 1e-8."""
    res_ref, x_ref = ref[case]
    for res in ranks:
        _close_history(res[case][0], res_ref, 1e-10)
        np.testing.assert_allclose(res[case][1], x_ref, rtol=1e-8,
                                   atol=1e-10)


def test_padding_is_exercised(ranks):
    """Level 1 of the 24^2 hierarchy has 102 rows: it is sharded with 2
    identity rows of padding."""
    lv = ranks[0]["levels_halo24"][1]
    assert lv["sharded"] and lv["rows"] == 104


@pytest.mark.parametrize("accel", ["cg", "gmres"])
def test_gspmd_20_solves_match_the_unsharded_port(ranks, accel):
    """The gspmd path's 20^2 CG and GMRES (inner products summed over the
    ranks, restart from the global size) against the same solve of the
    unsharded port: histories to 1e-10 of their first entry, x to
    1e-8."""
    from torch_dist_worker import build
    A, ml = build(20, 10)
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    want = []
    x = ml.to_device("cpu").solve(b, maxiter=30, tol=1e-10, accel=accel,
                                  residuals=want)
    for r in ranks:
        res, xr = r[f"gspmd20{accel}"]
        _close_history(res, want, 1e-10)
        np.testing.assert_allclose(xr, x.numpy(), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("key", ["cg3", "sa2", "halo2", "halo_cg", "halo24",
                                 "halo20cg", "gspmd20cg", "gspmd20gmres"])
def test_every_rank_stops_on_the_same_iteration(ranks, key):
    """Every rank holds the same residual history (the same iterations)
    and the same whole x."""
    for res in ranks[1:]:
        assert res[key][0] == ranks[0][key][0]
        assert res[key][1] == ranks[0][key][1]


def _predicted(levels):
    """The collectives of one V-cycle from the table of levels: on a
    sharded level every product with A (each color pass of both smoothers
    and the residual) gathers once on the gspmd path and sends one message
    per ring offset on the halo path; R and P gather where their input is
    split by rows; a replicated level communicates nothing."""
    gathers = sends = 0
    for lv in levels:
        if not lv["sharded"]:
            continue
        products = sum(lv["passes"]) + 1
        if lv["A"] == "HaloELL":
            sends += products * len(lv["offsets"])
        else:
            gathers += products
        gathers += int(lv["P_in"]) + int(lv["R_in"])
    return {"all_gather": gathers, "all_reduce": 0, "send": sends,
            "recv": sends}


@pytest.mark.parametrize("path", ["gspmd", "halo"])
def test_collectives_per_cycle_follow_the_levels(ranks, path):
    for res in ranks:
        levels = res[f"levels_{path}"]
        assert [lv["sharded"] for lv in levels] == [True, True, False, False]
        assert res[f"cycle_{path}"] == _predicted(levels)
    if path == "halo":
        assert ranks[0]["levels_halo"][0]["offsets"] == [1, 3]


def test_cg_reduces_once_per_inner_product(ranks):
    """CG for 3 iterations: ||b||, ||r0||, <r0, z0>, then <Ap, p>,
    <r, z> and ||r|| an iteration; 4 V-cycles and 1 + 3 products with A."""
    res = ranks[0]
    cyc = res["cycle_gspmd"]["all_gather"]
    assert res["cg3_counts"]["all_reduce"] == 3 + 3 * 3
    assert res["cg3_counts"]["all_gather"] == 4 * cyc + 4 + 1
