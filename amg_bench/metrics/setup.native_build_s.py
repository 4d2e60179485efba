"""Seconds the run spent building the program's native libraries: the
span ``native.build`` of each library looked for (nvcc for the CUDA
kernels and the conditional nodes, g++ for the host helpers), summed:
the compilers' time, or a few milliseconds of hashing the sources where
every library was found built."""

from amg_bench.harness.program_store import total


def read(rec):
    t = total("native.build")
    return t and t[1] / 1e9
