"""What the harness may load and read: no JAX and no JAX package
anywhere in it, the reference free of the program, nothing of the JAX
package's benchmarks read, and no result where a run may not run."""

import ast
import json
import os
import shutil
import subprocess
import sys

from amg_bench.harness import core

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "amg_bench")


def sources(sub=""):
    for base, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources():
        bad = set(top_level_imports(path)) & set(core.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert core.PROGRAM not in set(top_level_imports(path)), path


def test_nothing_reads_the_jax_packages_benchmarks():
    names = ("bench" + "marks/", "bench" + ".py", "bench" + "_suite.py",
             "BENCH_" + "r0", "SOLVE_" + "10M", "DIST_" + "SCALE")
    for path in sources():
        with open(path) as f:
            text = f.read()
        for name in names:
            assert name not in text, f"{path} names {name}"


def test_top_level_names_are_compared_whole():
    assert core.forbidden_modules(["pyamg_tpu_torch", "pyamg_tpu_torch.x",
                                   "numpy"]) == []
    assert core.forbidden_modules(["pyamg_tpu.ops", "jaxlib.xla",
                                   "jaxtyping"]) == ["jaxlib", "pyamg_tpu"]


def run_py(cwd, workload="gridsa_500sq.rhs"):
    return subprocess.run(
        [sys.executable, "amg_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_result_without_a_card():
    proc = run_py(ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_no_result_where_only_the_benchmark_is(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "amg_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    proc = run_py(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "not in this checkout" in proc.stderr


def test_paths_hold_the_benchmark_alone():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["amg_bench"]
    assert not os.path.exists(os.path.join(BENCH, core.PROGRAM))
