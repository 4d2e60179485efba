"""The comparison that decides ``correct``, shown to fail: each cell's
control (the plain reference in the precision below the configuration's,
in the program's place) and each fault the cell can have, planted in the
program's timed entry, come out not correct through the rest of a run;
the program itself comes out correct.  On the CPU at tiny grids (the
harness's look for a card is skipped); the control's readings at the
cells' own sizes come from ``amg_bench/readings.py`` on the card."""

import io
import time

import numpy as np
import pytest

from amg_bench.harness import core

SMALL = {"gridsa_500sq.rhs": {"grid": 48, "check_every": 3},
         "distsa_1414sq.rhs": {"grid": 80, "check_every": 2}}


def run(workload, monkeypatch=None, fault=None, control=False):
    factory = None
    if control:
        factory = core.load_cell(workload)[5].Control
    if fault is not None:
        plant(monkeypatch, workload, fault)
    out, err = io.StringIO(), io.StringIO()
    result = core.run(workload, 2 ** 31 + 77, 0.5, False, time.perf_counter(),
                      device="cpu", traffic_override=SMALL[workload],
                      cell_factory=factory, out=out, err=err)
    assert out.getvalue().strip().splitlines()[-1].startswith("{")
    assert "compared" in err.getvalue().splitlines()[-1]
    return result


def broken(x, fault):
    """x as the fault leaves it: never updated from its start (zero),
    half of its rows left out, or one entry altered where produced."""
    x = x.clone() if hasattr(x, "clone") else np.array(x, copy=True)
    if fault == "state_unchanged":
        x[:] = 0
    elif fault == "half_left_out":
        x[x.shape[0] // 2:] = 0
    else:
        x[x.shape[0] // 3] += 1.0
    return x


def plant(monkeypatch, workload, fault):
    if workload.startswith("gridsa"):
        from pyamg_tpu_torch.multilevel import MultilevelSolver as cls
        name = "solve_refined_device"
    else:
        from pyamg_tpu_torch.parallel import DistHierarchy as cls
        name = "solve_cg"
    real = getattr(cls, name)

    def solve(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if isinstance(out, tuple):
            return (broken(out[0], fault),) + out[1:]
        return broken(out, fault)
    monkeypatch.setattr(cls, name, solve)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_program_is_correct(workload):
    assert run(workload)["correct"] is True


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    result = run(workload, control=True)
    assert result["correct"] is False
    assert result["compared"]["relres_max"]["value"] > \
        result["compared"]["relres_max"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out",
                                   "answer_altered"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault,
                                                  monkeypatch):
    assert run(workload, monkeypatch, fault)["correct"] is False
