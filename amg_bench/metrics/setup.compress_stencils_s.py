"""Seconds of ``compress_stencils`` in the prep (DIA, PhaseStencil and
SELL forms built on the host): the program's span
``prep.compress_stencils``."""

from amg_bench.harness.program_store import total


def read(rec):
    t = total("prep.compress_stencils")
    return t and t[1] / 1e9
