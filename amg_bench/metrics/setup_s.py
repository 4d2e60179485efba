"""Seconds from the process's start to the first timed solve: imports,
the CUDA context, inputs, operator, hierarchy, prep, upload and the two
warm-up solves (the first captures the graphs)."""


def read(rec):
    return rec.get("setup_s")
