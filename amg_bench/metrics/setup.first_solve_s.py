"""Seconds of the first solve, which captures the solve's CUDA graphs
and builds its device loop, host clock ending in a synchronize."""


def read(rec):
    return rec["setup"].get("first_solve")
