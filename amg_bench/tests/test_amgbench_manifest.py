"""BENCHMARK.json against the contract's form, every name found by its
file, and a cell added by new files and entries alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "amg_bench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["amg_bench"]
    assert bench["command"] == ["python3", "amg_bench/run.py"]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and c["file"].startswith("amg_bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    assert len({w["name"] for w in bench["workloads"]}) == \
        len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) \
        == len(bench["workloads"])


def test_every_cell_reports_what_the_contract_asks(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells))
           for m in bench["end_to_end"]}
    assert e2e["setup_s"] == cells
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells
        # the metric it moves is reported in each of its cells
        assert set(m["workloads"]) <= e2e[m["moves"]]
    for cell in cells:
        assert sum(cell in c for c in e2e.values()) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_every_name_has_its_file(bench):
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(BENCH, "systems",
                                           cfg["system"] + ".py"))
        assert os.path.exists(os.path.join(ROOT, cfg["reference"]))
    for w in bench["workloads"]:
        assert w["config"] in configs
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) \
                as f:
            gen = json.load(f)["requests"]["generator"]
        assert os.path.exists(os.path.join(BENCH, "generators",
                                           gen + ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    s = bench["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix (with b drawn from
    another distribution), a per-layer metric and a cell through new files
    and new BENCHMARK.json entries only, and the new cell runs (on the
    CPU, at a tiny grid) with its new metric."""
    shutil.copytree(BENCH, tmp_path / "amg_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(os.path.join(ROOT, "pyamg_tpu_torch"),
               tmp_path / "pyamg_tpu_torch")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "traffic", "rhs_500sq.json")) as f:
        traffic = json.load(f)
    traffic.update(grid=40, check_every=2)
    traffic["requests"]["distribution"] = "uniform"
    (tmp_path / "amg_bench" / "traffic" / "rhs_40sq.json").write_text(
        json.dumps(traffic))
    (tmp_path / "amg_bench" / "metrics" / "solver.max_iters.py").write_text(
        "def read(rec):\n    return max(rec['inner'])\n")
    bench["workloads"].append({"name": "gridsa_40sq.rhs",
                               "config": "poisson2d_gridsa",
                               "traffic": "rhs_40sq", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "solver.max_iters",
                               "unit": "iterations", "better": "lower",
                               "source": "program_counter",
                               "layer": "Krylov and outer loop",
                               "moves": "solve_ms",
                               "workloads": ["gridsa_40sq.rhs"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys, time, json\n"
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "from amg_bench.harness import core\n"
        "core.run('gridsa_40sq.rhs', 5, 0.5, True, time.perf_counter(),\n"
        "         device='cpu')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["solver.max_iters"]["value"] >= 1
