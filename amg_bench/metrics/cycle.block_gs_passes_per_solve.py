"""Block Gauss-Seidel color passes a solve: the program's counter
``bell.gs_passes`` (counted on every replay of a captured graph) over its
``solve`` spans.  None where the program has no such counter."""

from amg_bench.harness.program_store import counter, per_solve


def read(rec):
    return per_solve(counter("bell.gs_passes"))
