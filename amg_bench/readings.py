"""The readings that the comparison's limits are set from, on the card at
a cell's own size: for each seed, the cell's window of ``--seconds`` at
its own load and the numbers the comparison computes (with the gap
between the true residual and the one the program reported), with the
program (the lower readings) or, with ``--control``, with the plain
reference in lower precision in the program's place (the upper
readings).  The set-up is made once a side; each seed draws its own
right-hand sides.

    python3 amg_bench/readings.py --workload <cell> --seeds 1,2,3 \\
        --seconds 20 [--control] [--out <file.jsonl>]

Prints one JSON line a seed (and appends it to ``--out``).  Not part of a
benchmark run."""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("TEARDOWN_CUPTI", "1")
sys.path.insert(0, ROOT)

from amg_bench.harness import core  # noqa: E402


def relres_gap(traffic, kept):
    """[largest, smallest] of (true float64 relative residual) minus (the
    relative residual the program reported) over the kept answers: how far
    the program's own stop reading lies from the float64 one that the
    comparison judges.  None for the control, which reports none."""
    from amg_bench.reference.poisson import poisson2d, true_relres
    A = poisson2d(traffic["grid"])
    gaps = [true_relres(A, b, x) - info["relres"] for _, b, x, info in kept
            if info.get("relres") is not None]
    return [max(gaps), min(gaps)] if gaps else None


def readings(workload, seeds, seconds, control=False, device=None,
             traffic_override=None, out=None):
    cell_entry, config, traffic, _, _, system = core.load_cell(
        workload, traffic_override)
    device = core.pick_device(device, int(cell_entry["chips"]), sys.stderr)
    if device is None:
        raise SystemExit(3)
    factory = system.Control if control else system.Cell
    cell = factory(config, traffic, seeds[0], device)
    t0 = time.perf_counter()
    cell.setup(lambda name: None)
    setup_s = time.perf_counter() - t0
    rows = []
    try:
        for seed in seeds:
            b_of = core.requests(traffic, seed)
            cell.solve(b_of(0))
            win = core.window(cell, b_of, traffic, seed, seconds)
            kept = cell.kept_to_host(win["kept"])
            numbers = system.compare(config, traffic, seed, cell.describe(),
                                     kept, device)
            row = {"workload": workload,
                   "side": "control" if control else "program",
                   "seed": seed, "setup_s": setup_s,
                   "solves": len(win["walls"]), "kept": len(kept),
                   "failed": win["failed"],
                   "iterations": sorted(set(win["inner"])),
                   "numbers": {n: v for n, v, _, _ in numbers},
                   "relres_gap": relres_gap(traffic, kept),
                   "passed": {n: ok for n, _, _, ok in numbers}}
            print(json.dumps(row), flush=True)
            if out:
                with open(out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            rows.append(row)
    finally:
        cell.free()
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    a = p.parse_args(argv)
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds,
             a.control, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
