"""K6 launches a solve: the program's counter ``dist_kernels.launches``
(one a sparse product of the distributed V-cycle and of the Krylov loop,
counted on every replay of a captured graph) over its ``solve`` spans.
None where the program has no such counter."""

from amg_bench.harness.program_store import counter, per_solve


def read(rec):
    return per_solve(counter("dist_kernels.launches"))
