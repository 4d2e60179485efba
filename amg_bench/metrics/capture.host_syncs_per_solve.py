"""Host syncs of one warm solve as the window runs it: reads of a CUDA
tensor's value and the captured loop's one read of its results."""


def read(rec):
    return rec.get("host_syncs_per_solve")
