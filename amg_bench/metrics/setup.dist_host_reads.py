"""Blocking host reads of the distributed set-up: the program's counter
``dist_setup.host_reads`` (each Luby round's count of active nodes, each
level's ghost margin, ranks and spectral radius, aggregates and drops)."""

from amg_bench.harness.program_store import counter


def read(rec):
    return counter("dist_setup.host_reads")
