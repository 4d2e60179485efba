"""The two cells of 2-D linear elasticity and Poisson at 1000^2: the
manifest takes them, the elasticity cell's comparison fails its control
(the plain reference in float32, no double-single residual) and every
fault planted in the program's timed entry and passes the program, the
1000^2 mix runs the grid system, and the block products' readers and
bound.  On the CPU at tiny grids (the harness's look for a card is
skipped)."""

import io
import json
import os
import time

import pytest

from amg_bench.harness import core
from amg_bench.tests.test_amgbench_control import broken
from amg_bench.yardstick.bell_bounds import (bell_spmv_bytes, bound_ms,
                                             shape_of)
from amg_bench.yardstick.bounds import HBM_BYTES_PER_S

ELAST, GRID = "elastsa_708sq.rhs", "gridsa_1000sq.rhs"
SMALL = {ELAST: {"grid": 24, "check_every": 3},
         GRID: {"grid": 48, "check_every": 3}}
BELL = ("cycle.bell_products_per_solve", "cycle.block_gs_passes_per_solve",
        "cycle.bell_bound_ms_per_solve")


def run(workload, trace=False, control=False, out=None):
    factory = core.load_cell(workload)[5].Control if control else None
    out, err = out or io.StringIO(), io.StringIO()
    result = core.run(workload, 2 ** 31 + 313, 0.5, trace,
                      time.perf_counter(), device="cpu",
                      traffic_override=SMALL[workload], cell_factory=factory,
                      out=out, err=err)
    assert "compared" in err.getvalue().splitlines()[-1]
    return result


def test_the_manifest_takes_both_cells():
    bench = core.load_json(core.ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    assert (cells[ELAST]["config"], cells[ELAST]["traffic"],
            cells[ELAST]["chips"]) == ("elasticity2d_sa", "rhs_el708sq", 1)
    assert (cells[GRID]["config"], cells[GRID]["traffic"],
            cells[GRID]["chips"]) == ("poisson2d_gridsa", "rhs_1000sq", 1)
    for name, grid in ((ELAST, 708), (GRID, 1000)):
        _, config, traffic, per_layer, end_to_end, _ = core.load_cell(name)
        assert traffic["grid"] == grid and traffic["tol"] == 1e-10
        assert {"solve_ms", "setup_s"} <= {m["name"] for m in end_to_end}
    # the 1000^2 cell is reported wherever the 500^2 one is
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            assert ("gridsa_500sq.rhs" in m["workloads"]) == \
                (GRID in m["workloads"]), m["name"]
    mine = {m["name"] for m in core.load_cell(ELAST)[3]}
    assert set(BELL) <= mine and "dia_spmv_roofline" not in mine


def test_the_elasticity_program_is_correct_with_its_block_metrics():
    result = run(ELAST, trace=True)
    assert result["correct"] is True and result["failed"] == 0
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(BELL) <= set(m)
    # a V-cycle's passes at 24^2: 4 x (4 + 5) colors on its two levels
    # above the coarsest; one cycle a CG iteration and one a correction,
    # 2 a solve (every b here takes 2 outer and 12 inner steps)
    assert m["cycle.block_gs_passes_per_solve"] == \
        36 * (m["solver.iters_per_solve"] + 2)
    assert m["cycle.bell_products_per_solve"] > \
        m["cycle.block_gs_passes_per_solve"] > 0
    assert 0 < m["cycle.bell_bound_ms_per_solve"] < 1


def test_the_elasticity_control_is_not_correct():
    result = run(ELAST, control=True)
    assert result["correct"] is False
    assert result["compared"]["relres_max"]["value"] > \
        result["compared"]["relres_max"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
def test_a_fault_in_the_elasticity_path_is_not_correct(fault, monkeypatch):
    from pyamg_tpu_torch.multilevel import MultilevelSolver
    real = MultilevelSolver.solve_refined_device

    def solve(self, *args, **kwargs):
        return broken(real(self, *args, **kwargs), fault)
    monkeypatch.setattr(MultilevelSolver, "solve_refined_device", solve)
    assert run(ELAST)["correct"] is False


def test_the_1000sq_mix_runs_the_grid_system():
    out = io.StringIO()
    result = run(GRID, out=out)
    assert result["correct"] is True
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == result


def test_bell_bound_of_a_counter_name():
    name = "bell.products[nb=501264,nbc=501264,bs=2x2,w=9,item=4]"
    shape = shape_of(name)
    assert shape == (501264, 501264, 2, 2, 9, 4)
    # level 0 of 708^2: 18.0 M values and 4.5 M int32 columns, x and y
    assert bell_spmv_bytes(*shape) == 501264 * 9 * (16 + 4) + 2 * 501264 * 8
    assert bound_ms({name: 3, "bell.products": 3, "other": 7}) == \
        pytest.approx(3 * bell_spmv_bytes(*shape) / HBM_BYTES_PER_S * 1e3)
    assert shape_of("bell.products") is None and bound_ms({}) == 0


def test_the_block_readers_find_nothing_without_the_counters(monkeypatch):
    """A program without the block counters (the parent of the change
    that added them) gives no reading and no error."""
    from pyamg_tpu_torch import _trace
    _trace.reset()
    monkeypatch.setattr(_trace, "snapshot", lambda: {
        "totals": {"solve": {"n": 3, "ns": 1}}, "counters": {}})
    for name in BELL:
        read = core.load_module(os.path.join(core.BENCH_DIR, "metrics",
                                             name + ".py"), name).read
        assert read({}) is None
