"""Milliseconds a solve of b's handling on its way in: the program's span
``solve.b_in`` (b's double-single split and its copies to the card, or
b's rows placed on the mesh, and the puts into the program), summed over
the run and divided by its solves (the ``solve`` spans)."""

from amg_bench.harness.program_store import per_solve, total


def read(rec):
    t = total("solve.b_in")
    return per_solve(t and t[1] / 1e6)
