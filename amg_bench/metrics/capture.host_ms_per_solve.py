"""Milliseconds of the capture layer's own host work around one replay
of a solve's device loop: the program's spans ``graph.reserve`` (K2's
epochs reserved for the most trips), ``graph.launch`` (the launch call)
and ``graph.count`` (the kernel counters run per trip after the read),
summed over the run and divided by the launches (``graph.launch``).  None
where no device loop ran (the CPU)."""

from amg_bench.harness.program_store import total


def read(rec):
    launches = total("graph.launch")
    if launches is None:
        return None
    ns = sum((total(n) or (0, 0))[1]
             for n in ("graph.reserve", "graph.launch", "graph.count"))
    return ns / launches[0] / 1e6
