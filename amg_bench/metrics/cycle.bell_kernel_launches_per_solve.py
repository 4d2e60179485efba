"""K7 launches a solve: the program's counter ``bell_kernels.launches``
(one a block product and one a block Gauss-Seidel color pass, counted on
every replay of a captured graph) over its ``solve`` spans.  None where
the program has no such counter."""

from amg_bench.harness.program_store import counter, per_solve


def read(rec):
    return per_solve(counter("bell_kernels.launches"))
