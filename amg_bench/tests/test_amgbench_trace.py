"""The per-layer metrics read from the program's own store of spans and
counters (``pyamg_tpu_torch/_trace.py``): both cells traced on the CPU at
tiny grids give a value for each such metric the CPU can have, and none
for what only the card records (the capture of CUDA graphs)."""

import io
import time

import pytest

from amg_bench.harness import core

SMALL = {"gridsa_500sq.rhs": {"grid": 40, "check_every": 3},
         "distsa_1414sq.rhs": {"grid": 80, "check_every": 2}}
STORE = ("solver.b_in_ms", "solver.x_out_ms",
         "solver.host_transfers_per_solve", "capture.host_ms_per_solve",
         "capture.read_wait_ms", "capture.record_s", "setup.native_build_s",
         "setup.compress_stencils_s", "setup.dist_mis_s",
         "setup.dist_host_reads")
# b's two halves in, the one read, x's pair out; b in and the read
TRANSFERS = {"gridsa_500sq.rhs": 4, "distsa_1414sq.rhs": 2}


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_store_metrics_of_a_traced_run(workload):
    from pyamg_tpu_torch import _trace
    _trace.reset()
    out, err = io.StringIO(), io.StringIO()
    result = core.run(workload, 2 ** 31 + 901, 0.5, True,
                      time.perf_counter(), device="cpu",
                      traffic_override=SMALL[workload], out=out, err=err)
    assert result["correct"] is True
    m = {k: v["value"] for k, v in result["metrics"].items()}
    mine = {k for k in STORE
            if workload in next(e for e in core.load_json(
                core.ROOT, "BENCHMARK.json")["per_layer"]
                if e["name"] == k)["workloads"]}
    # no CUDA graph is recorded or launched on the CPU; the grid path
    # looks for its g++ host helpers there, the distributed path for no
    # native library (its one, the conditional nodes, only on a card)
    absent = {"capture.host_ms_per_solve", "capture.record_s"}
    if workload.startswith("distsa"):
        absent.add("setup.native_build_s")
    assert {k for k in mine if k not in m} == absent
    assert m["solver.host_transfers_per_solve"] == TRANSFERS[workload]
    for k in ("solver.b_in_ms", "solver.x_out_ms", "capture.read_wait_ms"):
        assert m[k] > 0
    if workload.startswith("gridsa"):
        assert m["setup.compress_stencils_s"] > 0
    else:
        assert m["setup.dist_mis_s"] > 0
        assert m["setup.dist_host_reads"] >= 10
    if "setup.native_build_s" not in absent:
        assert m["setup.native_build_s"] >= 0
