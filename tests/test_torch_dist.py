"""The row-sharded solve across 4 processes (gloo on the CPU) against the
JAX package on a 4-device mesh.

The module starts the 4 ranks once (``tests/torch_dist_worker.py``, which
imports only the port) and every test reads their results: the dryrun's
three 32^2 flows (``__graft_entry__.dryrun_multichip``), the halo CG to
1e-8, and ``tests/test_halo.py``'s 24^2 standalone and 20^2 CG solves,
whose level 1 pads (102 and 70 rows over 4 ranks).  The JAX package's
histories come from ``jax_parallel_reference`` on ``make_row_mesh(4)``
over the conftest's virtual devices, in this process.

The ranks also run the sharded CG and GMRES as captured programs (the
stand-in of ``torch_stand_in.py``), equal bit for bit to op by op, and
the eight Krylov methods that the first sharded solve refused
(``jax_parallel_reference.KRYLOV``), against the JAX package's 4-device
histories, and three distributed setups with their solves
(``torch_dist_worker.DIST_SETUPS``) on the ``RowMesh`` of the 4
processes, which must equal, bit for bit, the same setups on a 4-rank
``StackedMesh`` in this process.
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
import torch_dist_worker as worker

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
        with np.load(out / f"rank{r}_levels.npz") as z:
            results[-1]["levels"] = dict(z)
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


@pytest.mark.parametrize("accel", ["cg", "gmres"])
def test_sharded_solves_as_programs_equal_op_by_op(ranks, accel):
    """The gspmd path's 20^2 CG and GMRES as captured programs (the
    stand-in of ``torch_stand_in.py``: every step recorded with its host
    reads refused, collectives included, and the loops run as a device
    runs them), twice, equal bit for bit to the same solves op by op, on
    every rank."""
    for res in ranks:
        rec = res[f"stand_in_{accel}"]
        assert rec["equal"] and rec["graphs"] > 0


@pytest.fixture(scope="module")
def krylov_ref():
    return jref.krylov_cases(ndev=WORLD)


@pytest.mark.parametrize("spmv", ["gspmd", "halo"])
@pytest.mark.parametrize("method", jref.KRYLOV)
def test_krylov_methods_match_the_jax_mesh(ranks, krylov_ref, method, spmv):
    """Each Krylov method for 3 iterations on the sharded 32^2 hierarchy:
    every rank's residual history to 1e-10 of the JAX package's on its
    4-device mesh (the halo path against the same history), and the same
    history and x on every rank."""
    key = f"{spmv}_{method}"
    want = krylov_ref[method]
    for res in ranks:
        assert len(res[key][0]) == len(want) == 4
        _close(res[key][0], want, 1e-10)
        assert res[key] == ranks[0][key]


@pytest.fixture(scope="module")
def stacked():
    """``DIST_SETUPS`` on a 4-rank ``StackedMesh`` in this process."""
    import torch
    from pyamg_tpu_torch.parallel import StackedMesh
    torch.set_num_threads(1)
    mesh = StackedMesh(WORLD, "cpu")
    out = {}
    for name, kind, n, cu, sk in worker.DIST_SETUPS:
        hier, (x, relres, it) = worker.dist_setup(name, kind, n, cu, sk,
                                                  mesh)
        out[name] = (worker.level_arrays(name, hier), x.numpy(), relres, it,
                     hier)
    return out


@pytest.mark.parametrize("name", [d[0] for d in worker.DIST_SETUPS])
def test_dist_setup_ranks_equal_the_stacked_mesh(ranks, stacked, name):
    """Each rank's block of every array of every level (the whole arrays
    where every rank holds them: the Chebyshev coefficients and the
    coarse pinv), its block of x, the relres, the iterations, the
    diagnostics, each omega and the operator complexity of the 4-process
    setup equal those of the 4-rank run in one process, bit for bit."""
    arrays, x, relres, it, hier = stacked[name]
    for r, res in enumerate(ranks):
        got = res["levels"]
        for key, a in list(arrays.items()) + [(f"{name}/x", x)]:
            whole = key.endswith(("/cheb", "/coarse_dense"))
            k = a.shape[0] // WORLD
            want = a if whole else a[r * k:(r + 1) * k]
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        rec = res["dist_setup"][name]
        assert (rec["relres"], rec["iterations"]) == (relres, it)
        assert rec["diagnostics"] == {k: hier.diagnostics[k] for k in
                                      ("margins", "nagg", "dropped")}
        assert rec["omega"] == [L.omega for L in hier.levels]
        assert rec["oc"] == hier.operator_complexity()


def test_dist_setup_exchanges_cross_ranks(ranks, stacked):
    """The 96^2 SA hierarchy has three sharded levels and a coarse margin
    wider than a rank's block (a ring exchange of more than one hop)."""
    hier = stacked["sa96"][4]
    assert len(hier.levels) >= 3
    assert any(L.g > L.n_loc for L in hier.levels[1:])
