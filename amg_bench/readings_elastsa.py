"""``readings.py`` for the elasticity cell (``elastsa_708sq.rhs``): the
same readings, with the gap between the true relative residual and the
one the program reported taken on the elasticity operator of the
reference (``reference/elasticity.py``), whose b's have two entries a
node.  Not part of a benchmark run.

    python3 amg_bench/readings_elastsa.py --workload elastsa_708sq.rhs \\
        --seeds 1,2,3 --seconds 20 [--control] [--out <file.jsonl>]"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from amg_bench import readings  # noqa: E402


def relres_gap(traffic, kept):
    """[largest, smallest] of (true float64 relative residual) minus (the
    relative residual the program reported) over the kept answers, on
    the elasticity operator; None for the control, which reports none."""
    from amg_bench.reference.elasticity import operator, true_relres
    A, _ = operator(traffic["grid"])
    gaps = [true_relres(A, b, x) - info["relres"] for _, b, x, info in kept
            if info.get("relres") is not None]
    return [max(gaps), min(gaps)] if gaps else None


readings.relres_gap = relres_gap

if __name__ == "__main__":
    sys.exit(readings.main())
