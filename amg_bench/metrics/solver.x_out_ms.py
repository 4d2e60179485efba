"""Milliseconds a solve of x's handling on its way out: the program's
span ``solve.x_out`` (the double-single pair read back and summed in
float64, or x's copy owned by the caller), summed over the run and
divided by its solves (the ``solve`` spans)."""

from amg_bench.harness.program_store import per_solve, total


def read(rec):
    t = total("solve.x_out")
    return per_solve(t and t[1] / 1e6)
