"""Captured solves: the port's counterpart of ``jax.jit`` for the solve
loops (no JAX counterpart file).

The JAX package runs each solve as one compiled program whose loop body
takes the hierarchy as arguments (``pyamg_tpu/multilevel.py``:
``_get_accel_run``, ``_get_standalone_run``, ``_get_ds_refined_run``).
Here a solve is a Python loop of named steps, each a function of one dict
of state tensors (a ``Program``), and the host reads one stop flag a step.
On a CUDA device each step is recorded once as a CUDA graph and replayed
on every later run, so the host launches one graph a step instead of
dispatching every torch operation of a cycle.  On the CPU, inside
``eager()`` and in a loop with a callback, the same step functions run op
by op.

A step ``step(state)`` returns a dict of new values for some keys of the
state, and may also write state tensors in place (a basis, a history).
Eagerly, the new values replace the entries.  Captured, every state
tensor is static: the first run of a step runs it once eagerly on a side
stream and copies its values into the static tensors (the warm-up: it
builds every tensor that a smoother or a kernel wrapper makes lazily, so
that the capture makes no host-to-device copy and grows no buffer), then
records the same step, with the same copies, as a graph in the program's
memory pool.  Each later run replays that graph.  A capture that fails
raises; nothing falls back to the eager loop.

The kernel wrappers count their launches in Python, which a replay does
not reach.  So a wrapper hands its bookkeeping to ``on_replay``: outside
a capture it runs at once; during a capture it is recorded, and runs
again before every replay of the graph (a launch count, K2's reservation
of its epochs).

A graph keeps the addresses of the memory it recorded.  What a kernel
wrapper keeps between launches (K2's exchange memory) therefore belongs,
for a captured launch, to the hierarchy's cache (``owned()`` while one of
its programs warms up or records), and lives as long as the cache's
graphs.
"""

from __future__ import annotations

import contextlib

import torch

_recording = None       # the replay hooks of the graph being recorded
_owner = None           # owned() of the program warming up or recording
_eager = False          # eager(): every program runs op by op


def on_replay(fn):
    """Host work ``fn`` of a kernel launch (its count, what it needs
    before it runs): done now or, while a program records a graph, before
    every replay of that graph."""
    if _recording is not None:
        _recording.append(fn)
    else:
        fn()


def owned():
    """The objects kept by the cache whose program is warming up or
    recording a graph (a dict; a kernel wrapper keeps there what the graph
    will read), else None."""
    return _owner


@contextlib.contextmanager
def eager():
    """Run every solve op by op, as the loops dispatched before capture
    (``chip_smoke.py`` and the tests compare the two)."""
    global _eager
    old, _eager = _eager, True
    try:
        yield
    finally:
        _eager = old


def _storage(t):
    return t.untyped_storage().data_ptr()


class Program:
    """The steps of one solve configuration on one dict of state tensors
    (``state``).  ``put`` sets an input, ``run(name, step)`` runs a step;
    ``captured`` says whether steps are graphs (``Graphs`` made it) or run
    eagerly."""

    captured = False

    def __init__(self):
        self.state = {}

    def put(self, key, value):
        self.state[key] = value

    def run(self, name, step):
        self._apply(step(self.state), copy=False)

    def static(self, key, make):
        """An object the steps write in place (a GMRES basis): made here,
        and kept by a captured program."""
        return make()

    def _apply(self, out, copy):
        st = self.state
        for k, v in out.items():
            old = st.get(k)
            if old is not None and (old.dtype != v.dtype or
                                    old.shape != v.shape):
                raise TypeError(
                    f"step output {k!r} is {v.dtype} {tuple(v.shape)}, the "
                    f"state {old.dtype} {tuple(old.shape)}")
        if not copy:
            st.update(out)
            return
        # a value that shares memory with a state tensor (or with another
        # value) is copied apart before any copy into the state, so that
        # no copy reads what another overwrote
        held = {_storage(t) for t in st.values()}
        values = {}
        for k, v in out.items():
            if st.get(k) is v:
                continue
            if _storage(v) in held:
                v = v.clone()
            held.add(_storage(v))
            values[k] = v
        for k, v in values.items():
            if k in st:
                st[k].copy_(v)
            else:
                st[k] = v


class _Graph:
    """One CUDA graph in a memory pool: ``capture(body)``, ``replay()``."""

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, body):
        self.graph.capture_begin(pool=self.pool)
        try:
            body()
        finally:
            self.graph.capture_end()

    def replay(self):
        self.graph.replay()


class Graphs(Program):
    """A captured program on ``device``: static state tensors, one graph a
    step name, recorded on ``stream`` into ``pool`` (shared by the programs
    of one hierarchy, whose graphs replay one at a time on one stream), and
    ``owned``, the objects its launches keep (shared the same way).
    ``graph_type(pool)`` makes a graph (``capture(body)``, ``replay()``);
    the tests pass a stand-in.  ``captures`` counts the graphs recorded
    and ``capture_s`` the seconds their warm-ups and captures took."""

    captured = True

    def __init__(self, device, stream, pool, graph_type=_Graph, owned=None):
        super().__init__()
        self.device = device
        self.stream = stream
        self.pool = pool
        self.owned = {} if owned is None else owned
        self.graph_type = graph_type
        self.graphs = {}
        self.objects = {}
        self.captures = 0
        self.capture_s = 0.0

    def put(self, key, value):
        st = self.state
        if key in st:
            if st[key].dtype != value.dtype or st[key].shape != value.shape:
                raise TypeError(f"input {key!r} is {value.dtype} "
                                f"{tuple(value.shape)}, the program's "
                                f"{st[key].dtype} {tuple(st[key].shape)}")
            st[key].copy_(value)
        else:
            st[key] = value.clone()

    def static(self, key, make):
        if key not in self.objects:
            self.objects[key] = make()
        return self.objects[key]

    def run(self, name, step):
        entry = self.graphs.get(name)
        if entry is None:
            self._record(name, step)
            return
        graph, hooks = entry
        for fn in hooks:
            fn()
        graph.replay()

    def _record(self, name, step):
        import time
        global _recording, _owner
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        here = torch.cuda.current_stream(self.device) if cuda else None
        ctx = torch.cuda.stream(self.stream) if cuda else \
            contextlib.nullcontext()
        if cuda:
            self.stream.wait_stream(here)
        if _recording is not None:
            raise RuntimeError("a graph is already being recorded")
        graph, hooks = self.graph_type(self.pool), []
        _owner = self.owned
        try:
            with ctx:
                # the warm-up: the step itself, eagerly, into the state
                self._apply(step(self.state), copy=True)
                _recording = hooks
                try:
                    graph.capture(lambda: self._apply(step(self.state),
                                                      copy=True))
                finally:
                    _recording = None
        finally:
            _owner = None
        if cuda:
            here.wait_stream(self.stream)
        self.graphs[name] = (graph, hooks)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


class Cache:
    """The programs of one hierarchy, by configuration key: eager ones
    made afresh for each solve, captured ones kept until ``drop``."""

    def __init__(self):
        self.programs = {}
        self.owned = {}
        self._stream = None
        self._pool = None

    def program(self, key, device, captured=True):
        """The program of ``key`` on ``device``: as ``transient``, and a
        captured one is kept under ``key``."""
        prog = self.transient(device, captured)
        if not prog.captured:
            return prog
        return self.programs.setdefault(key, prog)

    def transient(self, device, captured=True):
        """A program that is not kept: captured on a CUDA device (unless
        ``captured`` is False or inside ``eager()``; in the hierarchy's
        pool), else a fresh eager one."""
        if not captured or _eager or device is None or \
                device.type != "cuda":
            return Program()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return Graphs(device, self._stream, self._pool, owned=self.owned)

    def drop(self):
        """Forget every program and what their launches kept (the
        hierarchy's tensors changed); waits for the card first, so that no
        replay in flight reads memory the graphs free."""
        if (self.programs or self.owned) and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.programs = {}
        self.owned = {}

    def captured(self):
        """(graphs recorded, seconds of their warm-ups and captures)."""
        return (sum(p.captures for p in self.programs.values()),
                sum(p.capture_s for p in self.programs.values()))
