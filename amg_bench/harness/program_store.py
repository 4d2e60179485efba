"""What the program's own store of spans and counters holds
(``pyamg_tpu_torch/_trace.py``), for the readers of the per-layer metrics
that come from it.  The store lives in the run's process, so a reader
takes it after the window and the traced part.  A program without the
store gives nothing, and so does a name it never recorded."""


def snapshot():
    """``pyamg_tpu_torch._trace.snapshot()``, or None where the program
    has no such store."""
    try:
        from pyamg_tpu_torch import _trace
    except ImportError:
        return None
    return _trace.snapshot()


def total(name):
    """(spans closed, nanoseconds) of the span ``name`` (``name[form]``
    for one form), or None where none closed."""
    snap = snapshot()
    t = snap and snap["totals"].get(name)
    return (t["n"], t["ns"]) if t and t["n"] else None


def counter(name):
    """The counter ``name``, or None where it was never bumped."""
    snap = snapshot()
    return snap and snap["counters"].get(name)


def per_solve(ns_or_count):
    """A sum over the run as an amount a solve: over the root spans
    ``solve`` (one a call of a public solve entry), or None."""
    solves = total("solve")
    if ns_or_count is None or solves is None:
        return None
    return ns_or_count / solves[0]
