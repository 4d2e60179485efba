"""The byte bound of a block (BELL) product of the port, from the shape
the program's counter names (``bell.products[nb=..,nbc=..,bs=BRxBC,
w=..,item=..]``, one counter a shape): each stored block slot's values
and a 4-byte column index read once, x read once and y written once, at
the card's HBM rate (``bounds.py``).  What a product reads again (x's
blocks gathered once a slot) is not counted.  Frozen here so that a
later change to the program cannot move it."""

import re

from amg_bench.yardstick.bounds import bound_seconds

KEY = re.compile(r"^bell\.products\[nb=(\d+),nbc=(\d+),bs=(\d+)x(\d+),"
                 r"w=(\d+),item=(\d+)\]$")


def shape_of(counter_name):
    """(nb, nbc, br, bc, width, itemsize) of a per-shape counter's name,
    or None for any other name."""
    m = KEY.match(counter_name)
    return tuple(int(g) for g in m.groups()) if m else None


def bell_spmv_bytes(nb, nbc, br, bc, width, itemsize):
    """y = A x for a BELL of ``nb`` block rows of ``width`` slots of
    ``br`` x ``bc`` blocks over ``nbc`` block columns."""
    return (nb * width * (br * bc * itemsize + 4) + nbc * bc * itemsize
            + nb * br * itemsize)


def bound_ms(counters):
    """Milliseconds the card needs at least for every block product the
    counters hold (the sum over shapes of products x bound)."""
    total = 0.0
    for name, count in counters.items():
        shape = shape_of(name)
        if shape is not None:
            total += count * bound_seconds(bell_spmv_bytes(*shape))
    return total * 1e3
