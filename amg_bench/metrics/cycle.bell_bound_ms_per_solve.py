"""The least milliseconds a solve's block products could take: the
program's per-shape counters ``bell.products[...]`` turned into bytes
(each stored block's values and its int32 column once, x and y once) at
the HBM rate (``yardstick/bell_bounds.py``), over its ``solve`` spans.
None where the program counts no block product."""

from amg_bench.harness.program_store import per_solve, snapshot
from amg_bench.yardstick.bell_bounds import bound_ms, shape_of


def read(rec):
    snap = snapshot()
    counters = snap["counters"] if snap else {}
    if not any(shape_of(name) for name in counters):
        return None
    return per_solve(bound_ms(counters))
