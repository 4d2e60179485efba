"""Seconds of the distributed set-up's Luby MIS rounds, each with its
one blocking host read: the program's spans ``dist_setup.mis_round``,
summed."""

from amg_bench.harness.program_store import total


def read(rec):
    t = total("dist_setup.mis_round")
    return t and t[1] / 1e9
