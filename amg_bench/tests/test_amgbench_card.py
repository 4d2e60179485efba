"""Each cell run once end to end on a CUDA card, short: the result line's
form and ``correct``.  Skips without a card; on the card:

    python -m pytest amg_bench/tests/test_amgbench_card.py -q -p no:cacheprovider
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(workload, card):
    proc = subprocess.run(
        [sys.executable, "amg_bench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0
    assert result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
