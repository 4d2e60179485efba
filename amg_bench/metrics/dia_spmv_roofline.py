"""K1's share of its byte bound over the profiled solves: the sum over
its launches of each launch's bound (bytes from the operator's shape at
the HBM rate, ``yardstick/bounds.py``) over the sum of their device time
in the trace, in percent."""

from amg_bench.harness.roofline import share
from amg_bench.yardstick.bounds import bound_seconds, dia_spmv_bytes


def read(rec):
    return share(rec, "dia_spmv", ("dia_spmv_kernel",), dia_spmv_bytes,
                 bound_seconds)
