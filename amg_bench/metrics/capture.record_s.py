"""Seconds the run spent recording its solves' CUDA graphs: the program's
spans ``graph.warm`` (each step's eager warm-up), ``graph.capture`` (its
recording) and ``graph.build`` (the device loop's tree of conditional
nodes), summed.  None where nothing was recorded (the CPU)."""

from amg_bench.harness.program_store import total


def read(rec):
    found = [total(n) for n in ("graph.warm", "graph.capture",
                                "graph.build")]
    if not any(found):
        return None
    return sum(t[1] for t in found if t) / 1e9
