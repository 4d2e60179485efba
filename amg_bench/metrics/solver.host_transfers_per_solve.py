"""Host-device handoffs a solve: the program's counter ``host_transfers``
(each copy of b in, the captured loop's one read, each copy of x out)
over its ``solve`` spans."""

from amg_bench.harness.program_store import counter, per_solve


def read(rec):
    return per_solve(counter("host_transfers"))
