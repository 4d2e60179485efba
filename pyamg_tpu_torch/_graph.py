"""Captured solves: the port's counterpart of ``jax.jit`` for the solve
loops (no JAX counterpart file).

The JAX package runs each solve as one compiled program whose loop is a
``lax.while_loop`` on the device (``pyamg_tpu/multilevel.py``:
``_get_accel_run``, ``_get_standalone_run``, ``_get_ds_refined_run``).
Here a solve is a tree of named steps, each a function of one dict of
state tensors (a ``Program``), inside loops: ``While`` (run a body while
the state's stop flag is clear and its trip counter is below a limit),
``Every`` (one of two bodies, by the trip counter) and ``Switch`` (body k
of several, k a loop's counter: GMRES's Arnoldi step j).
``Program.loop`` runs the tree and reads the values the caller asks for
once at the end.

* Op by op (the CPU, ``eager()``, a loop with a callback), the host runs
  the loops and reads the stop flag once a trip.
* On a CUDA device each step is recorded once as a CUDA graph in the
  hierarchy's memory pool, and the whole tree becomes one CUDA graph of
  those steps with conditional nodes (``csrc/graph_cond.cu``): a WHILE
  node a loop, an IF node with an ELSE body an ``Every``, a SWITCH node a
  ``Switch``.  A solve is one
  replay and one host read at its end.  ``per_step()`` runs the steps'
  graphs with the loops on the host instead, one replay and one flag read
  a step (the form before the stop moved to the device; ``chip_smoke.py``
  and the tests compare the forms).

A step ``step(state)`` returns a dict of new values for some keys of the
state, and may also write state tensors in place (a basis, a history).
Eagerly, the new values replace the entries.  Captured, every state
tensor is static: a step's first run runs it once eagerly on a side
stream and copies its values into the static tensors (the warm-up: it
builds every tensor that a smoother or a kernel wrapper makes lazily, so
that the capture makes no host-to-device copy and grows no buffer), then
records the same step, with the same copies, as a graph.  Before the
first device-stopped run of a tree every step is warmed up so (the
steps' inputs are put back afterwards, and the warm-ups' launches are
not counted) and recorded.  A capture that fails raises; nothing falls
back to the eager loop.

The kernel wrappers count their launches in Python, which a replay does
not reach.  So a launch hands its bookkeeping to ``tally`` (a count,
folded into one call a graph and kind) and ``ahead`` (a reservation,
made before it: K2's epochs): outside a capture it runs at once; during
a capture it is recorded.  Before a step's replay the program runs what
the step recorded; around a device-stopped replay it reserves for the
most trips each step could make, and adds each step's counts once, times
the trips the device made of it (tallied on the device and read back in
the one read), so the host's count work does not grow with the trips.

A graph keeps the addresses of the memory it recorded.  What a kernel
wrapper keeps between launches (K2's exchange memory) therefore belongs,
for a captured launch, to the hierarchy's cache (``owned()`` while one of
its programs warms up or records), and lives as long as the cache's
graphs.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from pyamg_tpu_torch import _trace

_recording = None       # the replay hooks of the graph being recorded
_owner = None           # owned() of the program warming up or recording
_eager = False          # eager(): every program runs op by op
_per_step = False       # per_step(): a captured loop runs on the host
_quiet = False          # a device loop's warm-ups: launches not counted


class _Tally:
    """The counts of one kind recorded in one graph, by key: ``kind``
    adds them all in one call after each run of the graph, or, called
    with ``times``, after a device loop that ran it ``times`` times."""

    __slots__ = ("kind", "counts")

    def __init__(self, kind):
        self.kind, self.counts = kind, {}

    def __call__(self, times=1):
        self.kind(self.counts if times == 1 else
                  {key: n * times for key, n in self.counts.items()})


def tally(kind, key, n=1):
    """Count ``n`` under ``key`` through ``kind({key: n})``: now or, while
    a program records a graph, into the graph's one tally of that kind,
    counted once for every run of the graph (one host call a run, or a
    device loop's, for all the graph's counts of the kind)."""
    if _recording is None:
        if not _quiet:
            kind({key: n})
        return
    held = next((h for h in _recording
                 if isinstance(h, _Tally) and h.kind == kind), None)
    if held is None:
        held = _Tally(kind)
        _recording.append(held)
    held.counts[key] = held.counts.get(key, 0) + n


def ahead(holder, amount):
    """``holder.take(amount)`` before a kernel launch runs (K2 reserves
    its epochs): now or, while a program records a graph, before every
    replay of the graph, for as many runs as the replay may make."""
    if _recording is not None:
        _recording.append((holder, amount))
    else:
        holder.take(amount)


def owned():
    """The objects kept by the cache whose program is warming up or
    recording a graph (a dict; a kernel wrapper keeps there what the graph
    will read), else None."""
    return _owner


@contextlib.contextmanager
def eager():
    """Run every solve op by op, as the loops dispatched before capture
    (``chip_smoke.py`` and the tests compare the forms)."""
    global _eager
    old, _eager = _eager, True
    try:
        yield
    finally:
        _eager = old


@contextlib.contextmanager
def per_step():
    """Run a captured solve's loops on the host, one step's graph and one
    flag read at a time (``chip_smoke.py`` and the tests compare the
    forms)."""
    global _per_step
    old, _per_step = _per_step, True
    try:
        yield
    finally:
        _per_step = old


def _storage(t):
    return t.untyped_storage().data_ptr()


def _run_hooks(hooks):
    for h in hooks:
        if isinstance(h, tuple):
            h[0].take(h[1])
        else:
            h()


# -- the tree of a solve ---------------------------------------------------------

class Step:
    """Step ``name`` of ``prog``: ``fn(state)``."""

    def __init__(self, prog, name, fn):
        self.prog, self.name, self.fn = prog, name, fn


class While:
    """Run ``body`` (a list of nodes) while ``prog.state[stop]`` (bool) is
    clear and ``prog.state[count]`` (int32, the trips so far, which the
    body raises by one) is below ``limit``.  ``callback(state)`` after
    each trip (op by op only)."""

    def __init__(self, prog, body, limit, stop="stop", count="it",
                 callback=None):
        self.prog, self.body, self.limit = prog, body, int(limit)
        self.stop, self.count, self.callback = stop, count, callback


class Every:
    """``then`` on the trips of the enclosing ``While`` whose count plus
    one is a multiple of ``every``, else ``other``; ``count`` names the
    state's trip counter, equal to the trips so far."""

    def __init__(self, prog, every, then, other, count="it"):
        self.prog, self.every = prog, int(every)
        self.then, self.other, self.count = then, other, count


class Switch:
    """``branches[k]`` (a list of nodes; none when k is out of range)
    where ``prog.state[index]`` (an int32 scalar) holds k.  ``index`` is
    the counter of a ``While`` of the same program, around the switch or
    run before it, so that the host knows k without a read."""

    def __init__(self, prog, index, branches):
        self.prog, self.index = prog, index
        self.branches = [list(b) for b in branches]


def _walk(nodes, trips=1, body=None, branch=None):
    """(Step, the most times it runs, the body it is in, the Switch
    branch it is in) for every step of ``nodes``, in order; a body is a
    While or an (Every or Switch, side), a branch (id(Switch), k) of the
    nearest Switch around it, or None."""
    for node in nodes:
        if isinstance(node, Step):
            yield node, trips, body, branch
        elif isinstance(node, Every):
            yield from _walk(node.then, trips, (node, 0), branch)
            yield from _walk(node.other, trips, (node, 1), branch)
        elif isinstance(node, Switch):
            for k, b in enumerate(node.branches):
                yield from _walk(b, trips, (node, k), (id(node), k))
        else:
            yield from _walk(node.body, trips * node.limit, node, branch)


def _loops(nodes):
    """Every While, Every and Switch of ``nodes``, outer ones first."""
    for node in nodes:
        if isinstance(node, Every):
            yield node
            yield from _loops(node.then)
            yield from _loops(node.other)
        elif isinstance(node, Switch):
            yield node
            for b in node.branches:
                yield from _loops(b)
        elif isinstance(node, While):
            yield node
            yield from _loops(node.body)


def _slots(nodes):
    """({id(loop): its first tally slot}, slots): one slot a While's body,
    two an Every's (its sides), one a branch of a Switch."""
    slots, n = {}, 0
    for node in _loops(nodes):
        slots[id(node)] = n
        n += 2 if isinstance(node, Every) else \
            len(node.branches) if isinstance(node, Switch) else 1
    return slots, n


def _host(nodes, known):
    """Run ``nodes`` with the loops on the host (one read of the stop flag
    a trip, none once the trips reach the limit); ``known``: {(id(program),
    counter): its value}, the trips so far of each loop run (an Every and
    a Switch read theirs there)."""
    for node in nodes:
        if isinstance(node, Step):
            node.prog.run(node.name, node.fn)
        elif isinstance(node, Every):
            trips = known[(id(node.prog), node.count)]
            _host(node.then if (trips + 1) % node.every == 0 else node.other,
                  known)
        elif isinstance(node, Switch):
            key = (id(node.prog), node.index)
            if key not in known:
                raise ValueError(f"a Switch's index {node.index!r} must be "
                                 f"the counter of a loop run before it")
            k = known[key]
            if 0 <= k < len(node.branches):
                _host(node.branches[k], known)
        else:
            st = node.prog.state
            key = (id(node.prog), node.count)
            k = known[key] = 0
            while k < node.limit and not bool(st[node.stop]):
                _host(node.body, known)
                k = known[key] = k + 1
                if node.callback is not None:
                    node.callback(st)


def read(tensors):
    """The values of ``tensors`` (each a scalar or a vector) on the host,
    in one read: an int or a float for a scalar, a list for a vector
    (integers and flags as ints)."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float64)
                      for t in tensors]).tolist()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        vals = flat[i:i + n]
        if not (t.is_floating_point() or t.is_complex()):
            vals = [int(v) for v in vals]
        out.append(vals if t.ndim else vals[0])
        i += n
    return out


def _read_out(tensors, form):
    """``read`` of a loop's results, the solve's one handoff from the
    device (span ``graph.read``; ``form`` "step" after a loop run step by
    step on the host in ``per_step()``, else "device")."""
    with _trace.span("graph.read", form=form):
        _trace.count("host_transfers")
        return read(tensors)


class Program:
    """The steps of one solve configuration on one dict of state tensors
    (``state``).  ``put`` sets an input, ``run(name, step)`` runs a step,
    ``loop(name, nodes, keys)`` runs a tree; ``captured`` says whether
    steps are graphs (``Graphs`` made it) or run eagerly."""

    captured = False

    def __init__(self):
        self.state = {}

    def put(self, key, value):
        self.state[key] = value

    def run(self, name, step):
        self._apply(step(self.state), copy=False)

    def loop(self, name, nodes, keys=()):
        """Run the tree ``nodes`` (named ``name`` among this program's
        trees) and return the values of the state's ``keys`` after it, in
        one host read (``read``)."""
        _host(nodes, {})
        return _read_out([self.state[k] for k in keys],
                         "step" if self.captured else "device")

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
    """One CUDA graph in a memory pool: ``capture(body)``, ``replay()``,
    and ``raw()``, the ``cudaGraph_t`` that a device loop embeds."""

    def __init__(self, pool):
        self.pool = pool
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)

    def capture(self, body):
        # thread_local: a process group's watchdog thread polls its events
        # while a step with collectives records
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")
        try:
            body()
        finally:
            self.graph.capture_end()

    def replay(self):
        self.graph.replay()

    def raw(self):
        return self.graph.raw_cuda_graph()


_VP, _I32, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
_P = ctypes.POINTER
# the entry points of csrc/graph_cond.cu (each named pyamg_graph_<name>)
ENTRY_POINTS = {f"pyamg_graph_{name}": args for name, args in [
    ("new", [_P(_VP)]), ("free", [_VP]),
    ("zero", [_VP, _VP, _VP, _I32, _P(_VP)]),
    ("child", [_VP, _VP, _VP, _P(_VP)]),
    ("while", [_VP, _VP, _VP, _VP, _I32, _P(_U64), _P(_VP), _P(_VP)]),
    ("while_close", [_VP, _VP, _U64, _VP, _VP, _I32, _VP, _P(_VP)]),
    ("every", [_VP, _VP, _VP, _I32, _VP, _P(_VP), _P(_VP), _P(_VP)]),
    ("switch", [_VP, _VP, _VP, _I32, _VP, _P(_VP), _P(_VP)]),
    ("empty", [_VP, _VP, _P(_VP)]),
    ("switch_probe", [_VP, _VP, _VP, _VP, _VP]),
    ("node_types", [_VP, _VP, _I32]),
    ("alloc_context", [_VP, ctypes.c_char_p, _I32]),
    ("instantiate", [_P(_VP), _VP]), ("launch", [_VP, _VP]),
    ("exec_free", [_VP])]}


def _lib():
    """``csrc/graph_cond.cu`` (the conditional nodes of a device loop),
    built and bound at first use."""
    from pyamg_tpu_torch.ops import launch
    return launch.library("graph_cond", ENTRY_POINTS)


def _ok(rc, what):
    if rc != 0:
        raise RuntimeError(f"device loop: {what}: CUDA error {rc}")


_NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
               "wait event", "event record", "semaphore signal",
               "semaphore wait", "memory allocation", "memory free",
               "batch memory operation", "conditional")


def node_types(raw):
    """{type: count} of the nodes of the ``cudaGraph_t`` ``raw``, its
    child graphs' included."""
    counts = (ctypes.c_int32 * 16)()
    _ok(_lib().pyamg_graph_node_types(raw, counts, 16), "node types")
    return {(_NODE_TYPES[k] if k < len(_NODE_TYPES) else k): c
            for k, c in enumerate(counts) if c}


def alloc_context(raw):
    """Where the memory allocation and free nodes of the ``cudaGraph_t``
    ``raw`` sit: the kernels captured just before and after each."""
    buf = ctypes.create_string_buffer(8192)
    _ok(_lib().pyamg_graph_alloc_context(raw, buf, len(buf)),
        "allocation nodes")
    return buf.value.decode(errors="replace")


def probe_switch(device):
    """Run ``csrc/graph_cond.cu``'s SWITCH probe on ``device``: a graph
    of one SWITCH node of 3 bodies (body k writes k + 1) launched with the
    index 0, 1, 2 and 3.  Returns (the four values written, the tally of
    the three bodies): [1, 2, 3, 0] and [1, 1, 1] where the card runs
    SWITCH nodes; a refused node raises."""
    buf = torch.zeros(9, dtype=torch.int32, device=device)
    ptr = buf.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        _ok(_lib().pyamg_graph_switch_probe(ptr, ptr + 4, ptr + 8, ptr + 24,
                                            stream.cuda_stream),
            "SWITCH probe")
    vals = buf.tolist()
    return vals[2:6], vals[6:9]


class _DeviceLoop:
    """A tree as one CUDA graph: the steps' graphs as child graphs, each
    ``While`` a WHILE node, each ``Every`` an IF node with an ELSE body,
    each ``Switch`` a SWITCH node (CUDA 12.8; one body a branch), and
    ``tally[slot]`` raised on the device on every trip of a body (a
    While's, a side of an Every: two slots, a branch of a Switch: one
    each).  ``launch()`` runs it on the current stream."""

    def __init__(self, nodes, tally, slots):
        lib = _lib()
        self.lib = lib
        g = ctypes.c_void_p()
        _ok(lib.pyamg_graph_new(ctypes.byref(g)), "create")
        try:
            node = ctypes.c_void_p()
            _ok(lib.pyamg_graph_zero(g, None, tally.data_ptr(),
                                     tally.numel(), ctypes.byref(node)),
                "tally")
            self._chain(g, nodes, tally, slots, node)
            self.exec = ctypes.c_void_p()
            _ok(lib.pyamg_graph_instantiate(ctypes.byref(self.exec), g),
                "instantiate")
        finally:
            lib.pyamg_graph_free(g)

    def _chain(self, g, nodes, tally, slots, dep=None):
        """``nodes`` one after another in ``g`` (after ``dep``): the
        last node added."""
        for n in nodes:
            dep = self._add(g, dep, n, tally, slots)
        return dep

    def _body(self, g, nodes, tally, slots):
        """``nodes`` as the body ``g`` of a conditional node, an empty
        node where they add none."""
        if self._chain(g, nodes, tally, slots) is None:
            out = ctypes.c_void_p()
            _ok(self.lib.pyamg_graph_empty(g, None, ctypes.byref(out)),
                "empty body")

    def _add(self, g, dep, n, tally, slots):
        lib, out = self.lib, ctypes.c_void_p()
        if isinstance(n, While) and n.limit == 0:     # never runs
            return dep
        if isinstance(n, Step):
            raw = n.prog.graphs[n.name][0].raw()
            rc = lib.pyamg_graph_child(g, dep, raw, ctypes.byref(out))
            _ok(rc, f"step {n.name!r} (its nodes by type: "
                    f"{node_types(raw) if rc else None}; "
                    f"{alloc_context(raw) if rc else ''})")
            return out
        st = n.prog.state
        count = st[n.index if isinstance(n, Switch) else n.count]
        if count.dtype != torch.int32 or count.ndim:
            raise TypeError("a loop's counter or a switch's index must be "
                            "an int32 scalar")
        slot = tally[slots[id(n)]:].data_ptr()
        if isinstance(n, Switch):
            m = len(n.branches)
            bodies = (ctypes.c_void_p * m)()
            _ok(lib.pyamg_graph_switch(g, dep, count.data_ptr(), m, slot,
                                       bodies, ctypes.byref(out)),
                "SWITCH node")
            for k, branch in enumerate(n.branches):
                self._body(ctypes.c_void_p(bodies[k]), branch, tally, slots)
            return out
        if isinstance(n, Every):
            then, other = ctypes.c_void_p(), ctypes.c_void_p()
            _ok(lib.pyamg_graph_every(g, dep, count.data_ptr(), n.every,
                                      slot, ctypes.byref(then),
                                      ctypes.byref(other), ctypes.byref(out)),
                "IF node")
            self._body(then, n.then, tally, slots)
            self._body(other, n.other, tally, slots)
            return out
        stop = st[n.stop]
        if stop.dtype != torch.bool or stop.ndim:
            raise TypeError(f"a loop's flag {n.stop!r} must be a bool scalar")
        h, body = ctypes.c_ulonglong(), ctypes.c_void_p()
        _ok(lib.pyamg_graph_while(g, dep, stop.data_ptr(), count.data_ptr(),
                                  n.limit, ctypes.byref(h),
                                  ctypes.byref(body), ctypes.byref(out)),
            "WHILE node")
        last = self._chain(body, n.body, tally, slots)
        close = ctypes.c_void_p()
        _ok(lib.pyamg_graph_while_close(body, last, h, stop.data_ptr(),
                                        count.data_ptr(), n.limit, slot,
                                        ctypes.byref(close)), "WHILE body")
        return out

    def launch(self):
        _ok(self.lib.pyamg_graph_launch(
            self.exec, torch.cuda.current_stream().cuda_stream), "launch")

    def __del__(self):
        ex = getattr(self, "exec", None)
        if ex is not None and ex.value:
            self.lib.pyamg_graph_exec_free(ex)


def _reserve(plan):
    """Reserve, before a device loop's launch, for the most trips each of
    its steps could make (``plan`` as ``Graphs._build`` makes it); the
    branches of a Switch exclude each other, so a Switch reserves for its
    largest branch."""
    totals, branches = {}, {}
    for prog, sname, most, _, branch in plan:
        for h in prog.graphs[sname][1]:
            if isinstance(h, tuple):
                into = totals if branch is None else \
                    branches.setdefault(branch, {})
                held = into.setdefault(id(h[0]), [h[0], 0])
                held[1] += h[1] * most
    largest = {}
    for (switch, _), held in branches.items():
        for key, (holder, amount) in held.items():
            top = largest.setdefault((switch, key), [holder, 0])
            top[1] = max(top[1], amount)
    for (_, key), (holder, amount) in largest.items():
        totals.setdefault(key, [holder, 0])[1] += amount
    for holder, amount in totals.values():
        holder.take(amount)


class Graphs(Program):
    """A captured program on ``device``: static state tensors, one graph a
    step name, recorded on ``stream`` into ``pool`` (shared by the programs
    of one hierarchy, whose graphs replay one at a time on one stream), and
    ``owned``, the objects its launches keep (shared the same way).
    ``graph_type(pool)`` makes a step's graph (``capture(body)``,
    ``replay()``, ``raw()``) and ``loop_type(nodes, tally, slots)`` a
    tree's (``launch()``); the tests pass stand-ins.  ``captures`` counts
    the step graphs this program recorded and ``capture_s`` the seconds of
    its warm-ups, recordings and device loops' builds, both from its spans
    (``graph.warm``, ``graph.capture``, ``graph.build``)."""

    captured = True

    def __init__(self, device, stream, pool, graph_type=_Graph, owned=None,
                 loop_type=_DeviceLoop):
        super().__init__()
        self.device = device
        self.stream = stream
        self.pool = pool
        self.owned = {} if owned is None else owned
        self.graph_type = graph_type
        self.loop_type = loop_type
        self.graphs = {}
        self.loops = {}
        self.objects = {}
        self.inputs = {}
        self._spans = []

    def _span(self, name):
        s = _trace.span(name)
        self._spans.append(s)
        return s

    @property
    def captures(self):
        return sum(s.name == "graph.capture" for s in self._spans)

    @property
    def capture_s(self):
        return sum(s.seconds for s in self._spans)

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
        self.inputs[key] = value

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
        with _trace.span("graph.step", step=name):
            _run_hooks(hooks)
            graph.replay()

    def loop(self, name, nodes, keys=()):
        if _per_step:
            return super().loop(name, nodes, keys)
        entry = self.loops.get(name)
        if entry is None:
            entry = self.loops[name] = self._build(nodes)
        dev, tally, plan = entry
        with _trace.span("graph.reserve"):
            _reserve(plan)
        with _trace.span("graph.launch"):
            dev.launch()
        vals = _read_out([tally] + [self.state[k] for k in keys], "device")
        with _trace.span("graph.count"):
            trips = vals[0]
            for prog, sname, _, slot, _ in plan:
                times = 1 if slot is None else trips[slot]
                if times:
                    for h in prog.graphs[sname][1]:
                        if isinstance(h, _Tally):
                            h(times)
        return vals[1:]

    def _build(self, nodes):
        """Warm up and record every step of ``nodes`` not recorded yet,
        then make the tree's device loop: (loop, tally, [(program, step,
        most runs, tally slot or None, Switch branch or None)])."""
        global _quiet
        walked = list(_walk(nodes))
        slots, n_slots = _slots(nodes)
        walked = [w for w in walked if w[1] > 0]    # a loop of limit 0
        todo = [(s.prog, s.name, s.fn) for s, _, _, _ in walked
                if s.name not in s.prog.graphs]
        progs = {id(s.prog): s.prog for s, _, _, _ in walked}
        with self._side() as cuda:
            _quiet = True
            try:
                for prog, name, fn in todo:
                    # each warm-up from the state the ones before it made,
                    # its own writes undone: a step warmed up after another
                    # of its loop would run past the loop's limit
                    saved = [(t, t.clone()) for t in prog.state.values()]
                    prog._warm(name, fn)
                    for t, v in saved:
                        t.copy_(v)
            finally:
                _quiet = False
            for prog in progs.values():          # the inputs, as put
                for k, v in prog.inputs.items():
                    prog.state[k].copy_(v)
            for prog, name, fn in todo:
                prog._capture(name, fn)
            tally = torch.zeros(max(n_slots, 1), dtype=torch.int32,
                                device=self.device)
            with self._span("graph.build"):
                loop = self.loop_type(nodes, tally, slots)
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)
        plan = []
        for s, most, body, branch in walked:
            slot = None
            if body is not None:
                slot = slots[id(body[0])] + body[1] \
                    if isinstance(body, tuple) else slots[id(body)]
            plan.append((s.prog, s.name, most, slot, branch))
        return loop, tally, plan

    @contextlib.contextmanager
    def _side(self):
        """Warm-ups and captures: on the program's stream (after the work
        already queued), with the cache's objects ``owned()``."""
        global _owner
        cuda = self.device.type == "cuda"
        if cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        ctx = torch.cuda.stream(self.stream) if cuda else \
            contextlib.nullcontext()
        _owner = self.owned
        try:
            with ctx:
                yield cuda
        finally:
            _owner = None

    def _warm(self, name, step):
        """The warm-up of step ``name``: the step itself, eagerly, into
        the state."""
        with self._span("graph.warm"):
            self._apply(step(self.state), copy=True)

    def _capture(self, name, step):
        """Record ``step`` as graph ``name`` (its warm-up done)."""
        global _recording
        if _recording is not None:
            raise RuntimeError("a graph is already being recorded")
        with self._span("graph.capture"):
            graph, hooks = self.graph_type(self.pool), []
            _recording = hooks
            try:
                graph.capture(lambda: self._apply(step(self.state),
                                                  copy=True))
            finally:
                _recording = None
        self.graphs[name] = (graph, hooks)
        _trace.count("graph.recorded")

    def _record(self, name, step):
        with self._side() as cuda:
            self._warm(name, step)
            self._capture(name, step)
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


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
