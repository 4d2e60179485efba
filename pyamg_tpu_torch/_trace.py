"""The port's one store of spans and counters (no JAX counterpart file).

A span is a named interval of the host's clock (``time.perf_counter_ns``)
with its parent, the span open around it, and the id of the solve it
belongs to: each public solve entry opens a root span ``solve`` with a new
id (``entry``), and every span opened under it carries that id.  A
counter is a number bumped where the work happens (``count``).

Always on, for every span name: how many closed and their nanoseconds in
all (``snapshot()["totals"]``), and every counter.  A span opened with a
``form`` is totalled under ``<name>[<form>]`` as well.

Only while a ``torch.profiler`` session is active, or inside
``recording()``: each span is also kept raw in a bounded ring (name,
start, end, id, parent, solve id, attributes), and opened as a profiler
range named ``pyamg_tpu_torch::<name>`` (a host event of the trace, no
annotation on the device's timeline), which puts the program's spans on
the device trace's clock.

Spans opened from several threads at once share one stack, so their
parents are those of one thread's view; the totals stay right.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time

import torch

PREFIX = "pyamg_tpu_torch::"    # the profiler's name of a span: PREFIX + name
RING = 1 << 16                  # raw spans kept while recording

_now = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
# a profiler range that costs a few microseconds (no dispatcher); the
# profiler stamps it at the end of its enter and of its exit, so a span's
# start is read after the enter and its end after the exit
_Range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)

_totals = {}                    # name -> [spans closed, nanoseconds]
_counters = {}                  # name -> count
_ring = collections.deque(maxlen=RING)
_stack = []                     # the open spans, innermost last
_ids = itertools.count(1)
_solve = None                   # id of the open root ``solve`` span
_recording = 0                  # depth of recording()


class Span:
    """Span ``name``, opened now (``span``); closed by ``with`` or
    ``close()``, then ``ns`` and ``seconds``.  ``attrs`` may still be set
    while it is open."""

    __slots__ = ("name", "attrs", "start", "end", "id", "parent", "solve",
                 "_range")

    def __init__(self, name, /, **attrs):
        self.name = name
        self.attrs = attrs
        self.end = None
        self.id = next(_ids)
        self.parent = _stack[-1].id if _stack else None
        self.solve = _solve
        if _recording or _profiling():
            self._range = _Range(PREFIX + name)
            self._range.__enter__()
        else:
            self._range = None
        _stack.append(self)
        self.start = _now()

    @property
    def ns(self):
        return self.end - self.start

    @property
    def seconds(self):
        return (self.end - self.start) / 1e9

    def close(self):
        """End the span (once; a second close does nothing)."""
        if self.end is not None:
            return
        kept = self._range
        if kept is not None:
            kept.__exit__(None, None, None)
            self._range = None
        self.end = _now()
        if _stack and _stack[-1] is self:
            _stack.pop()
        elif self in _stack:
            _stack.remove(self)
        _total(self.name, self.end - self.start)
        form = self.attrs.get("form") if self.attrs else None
        if form is not None:
            _total(f"{self.name}[{form}]", self.end - self.start)
        if kept is not None:
            _ring.append({"name": self.name, "start": self.start,
                          "end": self.end, "id": self.id,
                          "parent": self.parent, "solve": self.solve,
                          "attrs": dict(self.attrs)})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


span = Span


def _total(name, ns):
    t = _totals.get(name)
    if t is None:
        t = _totals[name] = [0, 0]
    t[0] += 1
    t[1] += ns


def now():
    """The store's clock, in nanoseconds."""
    return _now()


def add(name, start, end, **attrs):
    """Record the span ``name`` that ran from ``start`` to ``end`` (the
    store's clock) and was not opened live; returns its nanoseconds."""
    ns = end - start
    _total(name, ns)
    if _recording or _profiling():
        _ring.append({"name": name, "start": start, "end": end,
                      "id": next(_ids),
                      "parent": _stack[-1].id if _stack else None,
                      "solve": _solve, "attrs": attrs})
    return ns


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def count_in(v):
    """Count the copy of a solve's input ``v`` onto the device
    (``host_transfers``) unless it is a tensor on a card already; the CPU
    counts what a card would."""
    if not (isinstance(v, torch.Tensor) and v.is_cuda):
        count("host_transfers")


def entry(fn):
    """Decorate a public solve entry: each call is one root span
    ``solve`` with a new solve id (attribute ``entry``, the function's
    name); a call inside another solve (an entry calling an entry) opens
    none."""
    name = fn.__qualname__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _solve
        if _solve is not None:
            return fn(*args, **kwargs)
        s = Span("solve", entry=name)
        _solve = s.solve = s.id
        try:
            return fn(*args, **kwargs)
        finally:
            s.close()
            _solve = None
    return wrapper


def traced(name):
    """Decorate a function: each call is one span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


@contextlib.contextmanager
def recording():
    """Keep raw spans in the ring (and name them to the profiler) inside
    this block, as while a ``torch.profiler`` session is active."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def snapshot():
    """The store as plain data: ``{"totals": {name: {"n", "ns"}},
    "counters": {name: n}, "spans": [raw spans, oldest first], "clock"}``."""
    return {"totals": {k: {"n": n, "ns": ns}
                       for k, (n, ns) in _totals.items()},
            "counters": dict(_counters),
            "spans": list(_ring),
            "clock": "perf_counter_ns"}


def reset(ring=None):
    """Clear the totals, counters and ring (``ring``: its new bound);
    spans open now still close into the store."""
    global _ring
    _totals.clear()
    _counters.clear()
    _ring = collections.deque(maxlen=_ring.maxlen if ring is None
                              else int(ring))
