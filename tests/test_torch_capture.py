"""The captured solve (``pyamg_tpu_torch/_graph.py``) on the CPU.

A CUDA graph exists only on the card.  Here a stand-in takes its place:
its capture runs the step once as the card records it, with every host
read of a tensor and every host-to-device copy made to raise (a tensor
made from host data, a Python number written into a tensor), then puts
the state back as it found it; its replay runs the step again.  So the
captured programs' own code runs here: the warm-up into static tensors,
the copies, the recorded launch bookkeeping.

* The bookkeeping: a stand-in wrapper's launches count once in the
  warm-up, not in the capture, and once more on every replay.
* Every step reads nothing on the host, for every cycle (V, W, F, AMLI),
  every coarse solver of ``test_torch_cycles.py``, every smoother of
  ``test_torch_relaxation.py`` and the double-single outer step; and each
  captured solve, run twice (warm-up and capture, then replays), equals
  the op-by-op solve (``_graph.eager()``) bit for bit.
* The loops equal the JAX package's: CG, GMRES, FGMRES and standalone
  cycling on its 32^2 hierarchy (``hierarchy_from_arrays``; iterations,
  ``info``, x and history to 1e-8 relative, as in
  ``test_torch_cycles.py``), and the double-single refined solve on its
  96^2 one (outer counts equal, inner within 1, x within 1e-8, as in
  ``test_torch_solve.py``).
* Each method that replaces the hierarchy's tensors drops its programs.
* ``profile_cycle`` returns a positive float and ``trace_cycle`` writes a
  trace into ``path`` and returns ``path``; the JAX package's own give the
  same kinds of result on the same hierarchy.
"""

import contextlib
import json
import os
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu_torch import _graph
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.classical import ruge_stuben_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.relaxation.smoothing import change_smoothers
from pyamg_tpu_torch.sparse.matrix import to_scipy

from test_torch_cycles import (COARSE, _close, _coarse_id, _vec,
                               _with_coarse, port, ref, restore_coarse)
from test_torch_relaxation import READS, SPECS, _custom
from test_torch_solve import (_check_against_reference, _ref_orders,
                              reference_solve)
from test_torch_solve import _spec as _ds_spec

torch.set_num_threads(1)

_FIXTURES = (port, ref, restore_coarse, reference_solve)


def _refuse(*args, **kwargs):
    raise AssertionError("host access inside a captured step")


@contextlib.contextmanager
def on_card_rules():
    """What a capture on the card refuses, made to raise on the CPU: a
    host read of a tensor, a tensor made from host data, a Python number
    written into a tensor."""
    real_as_tensor = torch.as_tensor
    real_setitem = torch.Tensor.__setitem__

    def as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            _refuse()
        return real_as_tensor(data, *args, **kwargs)

    def setitem(self, index, value):
        if isinstance(value, (bool, int, float, complex)):
            _refuse()
        return real_setitem(self, index, value)

    with pytest.MonkeyPatch.context() as mp:
        for name in READS:
            mp.setattr(torch.Tensor, name, _refuse)
        mp.setattr(torch, "tensor", _refuse)
        mp.setattr(torch, "from_numpy", _refuse)
        mp.setattr(torch, "as_tensor", as_tensor)
        mp.setattr(torch.Tensor, "__setitem__", setitem)
        yield


def _tensors(prog):
    out = list(prog.state.values())
    for obj in prog.objects.values():
        out += [t for t in vars(obj).values() if isinstance(t, torch.Tensor)]
    return out


class StandIn:
    """A CUDA graph's stand-in: ``capture(body)`` runs the step under
    ``on_card_rules`` from the state the warm-up started from, where the
    program recorded one (recording its launch bookkeeping), then puts
    the program's tensors back as it found them; ``replay()`` runs it
    again, its own tallies discarded (the program adds those the capture
    recorded)."""

    def __init__(self, prog):
        self.prog = prog
        self.body = None

    def capture(self, body):
        tensors = _tensors(self.prog)
        after = [t.clone() for t in tensors]
        for t in tensors:
            if id(t) in self.prog.before:
                t.copy_(self.prog.before[id(t)])
        self.prog.before = {}
        with on_card_rules():
            body()
        for t, a in zip(tensors, after):
            t.copy_(a)
        self.body = body

    def replay(self):
        saved = _graph._recording
        _graph._recording = []
        try:
            with on_card_rules():
                self.body()
        finally:
            _graph._recording = saved


_REAL = {name: getattr(torch.Tensor, name) for name in READS}


class StandInLoop:
    """A device loop's stand-in (``_graph._DeviceLoop``): ``launch()``
    runs the tree as the card does, each step by its stand-in graph's
    replay (under ``on_card_rules``), each While while its flag is clear
    and its counter below the limit, each Every by its counter, tallying
    the trips of each body.  Reading the flags and counters here is the
    stand-in modelling the device: it goes past the patches that count
    and refuse host reads."""

    def __init__(self, nodes, tally, slots):
        self.nodes, self.tally, self.slots = nodes, tally, slots

    def launch(self):
        self.tally.zero_()
        self._run(self.nodes)

    def _run(self, nodes):
        for n in nodes:
            if isinstance(n, _graph.Step):
                n.prog.graphs[n.name][0].replay()
                continue
            st, slot = n.prog.state, self.slots[id(n)]
            if isinstance(n, _graph.Every):
                then = (_REAL["__int__"](st[n.count]) + 1) % n.every == 0
                self.tally[slot + (0 if then else 1)] += 1
                self._run(n.then if then else n.other)
                continue
            while not _REAL["__bool__"](st[n.stop]) and \
                    _REAL["__int__"](st[n.count]) < n.limit:
                self._run(n.body)
                self.tally[slot] += 1


class StandInGraphs(_graph.Graphs):
    """A captured program on the CPU, graphs by ``StandIn`` and loops by
    ``StandInLoop``; it keeps the state as it was before each warm-up of a
    step run by itself, which the stand-in records from (on the card a
    capture runs nothing)."""

    def __init__(self, owned=None):
        super().__init__(torch.device("cpu"), None, None,
                         graph_type=lambda pool: StandIn(self), owned=owned,
                         loop_type=StandInLoop)
        self.before = {}
        self.before_warm = {}

    def _warm(self, name, step):
        self.before_warm[name] = {id(t): t.clone() for t in _tensors(self)}
        super()._warm(name, step)

    def _capture(self, name, step):
        self.before = self.before_warm.pop(name, {})
        super()._capture(name, step)


def _stand_in_program(owned=None):
    return StandInGraphs(owned)


@pytest.fixture
def captured(monkeypatch):
    """Every hierarchy's programs captured with the stand-in graph."""
    def transient(self, device, captured=True):
        if not captured or _graph._eager:
            return _graph.Program()
        return _stand_in_program(self.owned)

    monkeypatch.setattr(_graph.Cache, "transient", transient)


def _solve(ml, b, **kw):
    res = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x, info = ml.solve(b, residuals=res, return_info=True, **kw)
    return x, info, res


def _captured_equals_eager(ml, b, **kw):
    """Two captured solves (the first records, the second replays), one
    in each form (device-stopped, then one graph a step) and one op by op:
    equal bit for bit.  Returns the programs recorded."""
    with _graph.eager():
        want = _solve(ml, b, **kw)
    for form in (contextlib.nullcontext, contextlib.nullcontext,
                 _graph.per_step):
        with form():
            x, info, res = _solve(ml, b, **kw)
        assert torch.equal(x, want[0]) and info == want[1] and \
            res == want[2], (kw, form)
    return ml._graphs().captured()[0]


# -- the launch bookkeeping ------------------------------------------------------

def test_replays_add_the_recorded_launches():
    launches, hooks = [], []

    def wrapper(x):
        """A kernel wrapper's stand-in: prepares and counts each launch."""
        _graph.on_replay(lambda: hooks.append(len(launches)))
        _graph.on_replay(lambda: launches.append(1))
        return 2 * x

    prog = _stand_in_program()
    prog.put("x", torch.ones(4))

    def step(s):
        return {"y": wrapper(wrapper(s["x"]))}

    prog.run("two", step)         # the warm-up counts, the capture records
    assert len(launches) == 2 and hooks == [0, 1]
    assert len(prog.graphs["two"][1]) == 4
    for k in range(3):
        prog.put("x", torch.full((4,), float(k)))
        prog.run("two", step)
        assert torch.equal(prog.state["y"], torch.full((4,), 4.0 * k))
        assert len(launches) == 4 + 2 * k
        # the hooks run in launch order, before the replay
        assert hooks[-2:] == [2 + 2 * k, 3 + 2 * k]
    assert prog.captures == 1


def test_each_cache_owns_the_k2_exchange_its_graphs_record():
    """K2's exchange memory, whose addresses a graph records, belongs to
    the cache whose program recorded it: its programs share it, no other
    cache does, eager launches keep the stream's, and a drop lets it go."""
    from pyamg_tpu_torch.ops import dia_kernels as dk
    cpu, seen, got = torch.device("cpu"), [], []

    def step(s):
        seen.append(dk._exchange(cpu, "test"))
        return {"y": s["x"] + 1}

    caches = [_graph.Cache(), _graph.Cache()]
    for cache in caches:
        for _ in range(2):                  # two programs of one cache
            prog = _stand_in_program(cache.owned)
            prog.put("x", torch.ones(2))
            seen.clear()
            prog.run("s", step)             # the warm-up and the capture
            assert len(seen) == 2 and seen[0] is seen[1]
            got.append(seen[0])
    assert got[0] is got[1] and got[2] is got[3] and got[0] is not got[2]
    assert all(ex.retired == [] for ex in got)
    eager = dk._exchange(cpu, "test")
    assert all(eager is not ex for ex in got) and eager.retired is None
    caches[0].drop()
    prog = _stand_in_program(caches[0].owned)
    prog.put("x", torch.ones(2))
    seen.clear()
    prog.run("s", step)
    assert seen[0] is not got[0] and seen[0] is not got[2]


def test_a_step_that_reads_the_host_fails_to_capture():
    prog = _stand_in_program()
    prog.put("x", torch.ones(3))

    def step(s):
        return {"y": s["x"] * float(s["x"].sum())}

    with pytest.raises(AssertionError, match="host access"):
        prog.run("bad", step)


def test_outputs_that_share_memory_are_copied_apart():
    """A step that returns one tensor under two keys (CG's p = z) or an
    input as an output (x_best = x): the static tensors stay distinct."""
    prog = _stand_in_program()
    prog.put("x", torch.arange(3.0))

    def start(s):
        z = s["x"] + 1
        return {"z": z, "p": z, "xb": s["x"]}

    def step(s):
        return {"x": s["p"] * 2, "p": s["x"], "z": s["z"] + 1}

    prog.run("start", start)
    st = prog.state
    assert len({t.data_ptr() for t in st.values()}) == 4
    eager = _graph.Program()
    eager.put("x", torch.arange(3.0))
    eager.run("start", start)
    for _ in range(3):
        prog.run("step", step)
        eager.run("step", step)
        for k in ("x", "z", "p", "xb"):
            assert torch.equal(prog.state[k], eager.state[k]), k


def test_a_step_may_not_change_a_state_tensor_shape():
    prog = _graph.Program()
    prog.put("x", torch.ones(3))
    with pytest.raises(TypeError):
        prog.run("s", lambda s: {"x": torch.ones(4)})


# -- the device loop ------------------------------------------------------------

class _Holder:
    """What ``_graph.ahead`` reserves from (K2's exchange): the amounts
    taken, in order."""

    def __init__(self):
        self.taken = []

    def take(self, amount):
        self.taken.append(amount)


def _loop_tree(prog, inner, log, holder):
    """An outer loop of 4 trips (``k``) whose body feeds an inner program
    and runs its loop of k + 2 trips, each trip step A (every 2nd) or B;
    the steps count through a stand-in wrapper (``log``) and reserve 3
    units of ``holder`` a launch."""
    def wrapper(tag, x):
        _graph.ahead(holder, 3)
        _graph.on_replay(lambda: log.append(tag))
        return x * 2 + 1

    zero_i = torch.zeros((), dtype=torch.int32)

    def start(s):
        return {"k": zero_i.clone(), "tot": s["x0"] * 0,
                "stop": zero_i < 0}

    def feed(s):
        return {"x": prog.state["tot"] + prog.state["k"],
                "it": zero_i.clone(),
                "want": prog.state["k"] + 2, "stop": zero_i > 0}

    def side(tag):
        def fn(s):
            it = s["it"] + 1
            return {"x": wrapper(tag, s["x"]), "it": it,
                    "stop": it >= s["want"]}
        return fn

    def outer(s):
        k = s["k"] + 1
        return {"k": k, "tot": s["tot"] + inner.state["x"],
                "stop": k >= 4}

    inner_loop = _graph.While(inner, [_graph.Every(
        inner, 2, [_graph.Step(inner, "A", side("A"))],
        [_graph.Step(inner, "B", side("B"))])], 9)
    return [_graph.Step(prog, "start", start),
            _graph.While(prog, [_graph.Step(inner, "feed", feed), inner_loop,
                                _graph.Step(prog, "outer", outer)], 6,
                         count="k")]


def test_device_loop_counts_each_step_by_its_trips():
    """A nested tree run as one device loop (stand-in) gives the op-by-op
    result, and each step's launches count once for every trip the device
    made of it: inner trips 2 + 3 + 4 + 5, of which 6 take A (every 2nd
    of each inner loop), not the 7 that the total would give; the warm-ups
    count nothing.  The reservations come before the replay, one for the
    most trips (6 outer x 9 inner, 3 units each of A and B); the warm-ups
    of A and B, launched for real, reserve their own."""
    log, holder = [], _Holder()
    eager = _graph.Program()
    eager.put("x0", torch.ones(3))
    want = eager.loop("t", _loop_tree(eager, _graph.Program(), log, holder),
                      ("k", "tot"))
    assert want[0] == 4 and sorted(log) == ["A"] * 6 + ["B"] * 8
    assert holder.taken == [3] * 14
    log, holder = [], _Holder()
    prog, inner = _stand_in_program(), _stand_in_program()
    prog.put("x0", torch.ones(3))
    tree = _loop_tree(prog, inner, log, holder)
    for taken in ([3, 3, 2 * 3 * 6 * 9], [2 * 3 * 6 * 9]):
        log.clear()
        holder.taken.clear()
        assert prog.loop("t", tree, ("k", "tot")) == want
        assert sorted(log) == ["A"] * 6 + ["B"] * 8
        assert holder.taken == taken


def test_a_device_loop_reads_the_host_once(monkeypatch):
    """The tree's result comes back in one host read; the loop's own
    flags are read on the device (the stand-in)."""
    log, holder = [], _Holder()
    prog, inner = _stand_in_program(), _stand_in_program()
    prog.put("x0", torch.ones(3))
    tree = _loop_tree(prog, inner, log, holder)
    prog.loop("t", tree, ("k",))             # records
    counts = _count_reads(monkeypatch)
    assert prog.loop("t", tree, ("k", "tot"))[0] == 4
    assert counts["n"] == 1


def _count_reads(monkeypatch):
    counts = {"n": 0}
    for name in READS:
        def counted(*args, _real=_REAL[name], **kwargs):
            counts["n"] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(torch.Tensor, name, counted)
    return counts


@pytest.mark.parametrize("accel", [None, "cg"], ids=["standalone", "cg"])
def test_device_stopped_solves_read_the_host_once(ref, accel, monkeypatch,
                                                  restore_coarse, captured):
    """A device-stopped solve reads the host once, at its end (the
    iterations, the flag, ``info`` and the history together); one graph
    a step reads once more a step and once after ``start``."""
    ml = _with_coarse(ref, "pinv")
    b = _vec(17, ml.levels[0].A.shape[0])
    _solve(ml, b, accel=accel, tol=1e-8, maxiter=40)     # records
    reads = {}
    for name, form in (("device", contextlib.nullcontext),
                       ("per step", _graph.per_step)):
        counts = _count_reads(monkeypatch)
        with form():
            x, info, res = _solve(ml, b, accel=accel, tol=1e-8, maxiter=40)
        monkeypatch.undo()
        reads[name] = counts["n"]
    assert info == 0 and len(res) > 3
    assert reads == {"device": 1, "per step": len(res) - 1 + 2}


def test_device_stopped_ds_solve_reads_the_host_once(monkeypatch, captured):
    """The double-single refined solve: one read of its loop's result
    (outer and inner counts, history) and one of x."""
    A64, ml = _ds_hierarchy(24)
    b = _vec(18, A64.shape[0])
    ml.solve_refined_device(b)                          # records
    counts = _count_reads(monkeypatch)
    it = {}
    ml.solve_refined_device(b, iterations_out=it, residuals=[])
    assert counts["n"] == 2 and it["outer"] >= 1 and it["inner"] > 2


@pytest.mark.parametrize("maxiter", [0, 1, 2])
@pytest.mark.parametrize("accel", [None, "cg", "ds"])
def test_device_stopped_solves_at_the_smallest_limits(accel, maxiter,
                                                      captured):
    """Loops of 0, 1 and 2 trips at most: the device-stopped solve (whose
    first run warms up every step of its tree, each from the state before
    it) equals the op-by-op one, twice."""
    A64, ml = _ds_hierarchy(24)
    b = _vec(20, A64.shape[0])

    def run():
        if accel == "ds":
            res, it = [], {}
            x = ml.solve_refined_device(b, max_outer=max(maxiter, 1),
                                        inner_maxiter=maxiter, tol=1e-14,
                                        residuals=res, iterations_out=it)
            return x, res, it
        return _solve(ml, b, accel=accel, tol=1e-14, maxiter=maxiter)

    with _graph.eager():
        want = run()
    for _ in range(2):
        got = run()
        assert np.array_equal(np.asarray(got[0]), np.asarray(want[0])) and \
            got[1:] == want[1:]


@pytest.mark.parametrize("kw", [{"accel": "cg"}, {}], ids=["cg",
                                                           "standalone"])
def test_a_callback_keeps_the_host_loop(kw, captured):
    """With a callback the loop stays on the host, op by op, and sees every
    iterate; without one the same solve is one device loop with the same
    result."""
    A64, ml = _ds_hierarchy(24)
    b = _vec(19, A64.shape[0])
    seen = []
    x_cb = ml.solve(b, maxiter=5, callback=lambda x: seen.append(x.clone()),
                    **kw)
    assert len(seen) == 5 and ml._graphs().programs == {}
    x = ml.solve(b, maxiter=5, **kw)
    assert torch.equal(x, x_cb)
    (prog,) = ml._graphs().programs.values()
    assert len(prog.loops) == 1


# -- no host read, and replay equals dispatch -----------------------------------

@pytest.mark.parametrize("kind", COARSE, ids=_coarse_id)
def test_captured_solves_read_nothing_and_equal_dispatch(ref, kind,
                                                         restore_coarse,
                                                         captured):
    ml = _with_coarse(ref, kind)
    b = _vec(11, ml.levels[0].A.shape[0])
    for cycle in ("V", "W", "F", "AMLI"):
        for accel in (None, "cg", "gmres", "fgmres"):
            _captured_equals_eager(ml, b, cycle=cycle, accel=accel, tol=1e-12,
                                   maxiter=3)
    # standalone: start, cycle; CG: start, true, plain (the true residual's
    # step is recorded with the rest, though 3 iterations never reach it);
    # GMRES and FGMRES: init, begin, three Arnoldi steps, the update,
    # final; each cycle apart
    assert ml._graphs().captured()[0] == 4 * (2 + 3 + 7 + 7)


def _smoothed(spec):
    """A 16^2 hierarchy smoothed by ``spec`` (Ruge-Stuben, whose levels
    carry the C/F splitting, for the splitting smoothers)."""
    name = spec if callable(spec) else spec[0]
    A = poisson((16, 16))
    if name in ("cf_jacobi", "fc_jacobi"):
        ml = ruge_stuben_solver(A, max_coarse=10, presmoother=spec,
                                postsmoother=spec)
    else:
        ml = smoothed_aggregation_solver(A, max_coarse=10, presmoother=spec,
                                         postsmoother=spec)
    return ml.to_device("cpu")


@pytest.mark.parametrize("spec", SPECS + [(_custom, {})],
                         ids=lambda s: s[0] if isinstance(s[0], str)
                         else "callable")
def test_every_smoother_reads_nothing_in_a_captured_step(spec, captured):
    ml = _smoothed(_custom if spec[0] == "custom" else spec)
    b = _vec(12, ml.levels[0].A.shape[0])
    for accel in (None, "cg"):
        _captured_equals_eager(ml, b, accel=accel, tol=1e-12, maxiter=3)


def _ds_hierarchy(n=40, collapse=True):
    A64 = poisson((n, n))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils()
    if collapse:
        ml.collapse_coarse(max_n=200, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    return A64, ml.to_device("cpu")


def test_ds_refined_steps_read_nothing_and_equal_dispatch(captured):
    A64, ml = _ds_hierarchy()
    b = _vec(13, A64.shape[0])

    def run():
        res, it = [], {}
        x = ml.solve_refined_device(b, residuals=res, iterations_out=it)
        return x, res, it

    with _graph.eager():
        want = run()
    for form in (contextlib.nullcontext, contextlib.nullcontext,
                 _graph.per_step):
        with form():
            x, res, it = run()
        assert np.array_equal(x, want[0]) and res == want[1] and \
            it == want[2]
    # the outer start and step, and the inner solve's inputs (feed), CG's
    # start and its two forms of iteration, under keys of their own
    assert ml._graphs().captured()[0] == 6
    assert {k[0] for k in ml._graphs().programs} == {"ds", "ds-cg"}
    assert it["outer"] == 2 and res[-1] < 1e-10 * res[0]


def test_solve_refined_inner_solves_replay(captured):
    A64, ml = _ds_hierarchy()
    b = _vec(14, A64.shape[0])
    with _graph.eager():
        want = ml.solve_refined(b, A_fine=to_scipy(A64), tol=1e-10)
    for _ in range(2):
        x = ml.solve_refined(b, A_fine=to_scipy(A64), tol=1e-10)
        assert np.array_equal(x, want)
    assert set(ml._graphs().programs) == {("cg", "V", 1e-5, 30)}


# -- against the JAX package ---------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"accel": "cg"}, {"accel": "gmres"}, {"accel": "fgmres"},
    {"accel": "cg", "cycle": "W"}, {"accel": "gmres", "cycle": "F"},
    {}, {"cycle": "W"}, {"cycle": "AMLI"}], ids=str)
def test_captured_loops_match_reference(ref, port, kw, captured):
    n = ref.levels[0].A.shape[0]
    b = _vec(8, n)
    want_res = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, want_info = ref.solve(jnp.asarray(b), tol=1e-8, maxiter=40,
                                    residuals=want_res, return_info=True,
                                    **kw)
    for _ in range(2):
        got, info, got_res = _solve(port, b, tol=1e-8, maxiter=40, **kw)
        assert info == want_info and len(got_res) == len(want_res) > 2
        _close(got_res, want_res, 1e-8)
        _close(got, want, 1e-8)
    assert port._graphs().captured()[0] > 0


def test_captured_ds_refined_matches_reference(reference_solve, monkeypatch,
                                               captured):
    from pyamg_tpu_torch import hierarchy_from_arrays
    _, ml_ref, b, _, _ = reference_solve
    spec = _ds_spec(ml_ref, _ref_orders(ml_ref, monkeypatch))
    ml = hierarchy_from_arrays(spec, device="cpu")
    for _ in range(2):
        it = {}
        x = ml.solve_refined_device(b, tol=1e-10, iterations_out=it)
        _check_against_reference(x, it, reference_solve)
    assert ml._graphs().captured()[0] >= 4


# -- the cache ------------------------------------------------------------------

def _cached(collapse=True):
    A64, ml = _ds_hierarchy(24, collapse)
    b = _vec(15, A64.shape[0])
    ml.solve(b, accel="cg", maxiter=3)
    ml.solve_refined_device(b, max_outer=1)
    assert len(ml._graphs().programs) == 3
    return A64, ml


def _methods():
    def change_solve_matrix(A64, ml):
        ml.change_solve_matrix(A64.astype(np.float32))

    def smoothers(A64, ml):
        spec = ("jacobi", {"omega": 0.5, "withrho": False})
        change_smoothers(ml, spec, spec)

    def compress(A64, ml):
        ml.compress_stencils()

    def collapse(A64, ml):
        ml.collapse_coarse(max_n=200, device="cpu")

    return {"to_device": lambda A64, ml: ml.to_device("cpu"),
            "compress_stencils": compress,
            "collapse_coarse": collapse,
            "enable_ds_refinement":
                lambda A64, ml: ml.enable_ds_refinement(A64, device="cpu"),
            "change_solve_matrix": change_solve_matrix,
            "change_smoothers": smoothers}


@pytest.mark.parametrize("method", list(_methods()))
def test_methods_that_replace_tensors_drop_the_programs(method, captured):
    A64, ml = _cached(collapse=method != "collapse_coarse")
    _methods()[method](A64, ml)
    assert ml._graphs().programs == {} and ml._graphs().owned == {}
    # and the next solve records afresh and still converges
    x = ml.solve(_vec(15, A64.shape[0]), accel="cg", tol=1e-8)
    assert bool(torch.isfinite(x).all())
    assert len(ml._graphs().programs) == 1


def test_a_twin_starts_without_programs(captured):
    _, ml = _cached()
    twin = ml.as_dtype(torch.float64)
    assert twin._graphs() is not ml._graphs()
    assert twin._graphs().programs == {}
    assert len(ml._graphs().programs) == 3


def test_a_callback_runs_op_by_op(captured):
    A64, ml = _ds_hierarchy(24)
    seen = []
    ml.solve(_vec(16, A64.shape[0]), accel="cg", maxiter=3,
             callback=lambda x: seen.append(x.clone()))
    assert len(seen) == 3 and ml._graphs().programs == {}


# -- profile_cycle and trace_cycle ---------------------------------------------

def test_profile_cycle_matches_the_reference_kind(ref, port):
    t = port.profile_cycle()
    t_ref = ref.profile_cycle()
    assert isinstance(t, float) and t > 0
    assert isinstance(t_ref, float) and t_ref > 0


def test_profile_cycle_captured(port, captured):
    kept = dict(port._graphs().programs)
    t = port.profile_cycle("W", k1=2, k2=5)
    assert isinstance(t, float) and t > 0
    assert port._graphs().programs == kept      # nothing kept


def test_trace_cycle_writes_a_trace_into_path(ref, port, tmp_path,
                                              captured):
    path = str(tmp_path / "port")
    assert port.trace_cycle(path, cycle="V", iterations=3) == path
    with open(os.path.join(path, "cycle_trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("dia_spmv" in e.get("name", "") or
               "aten::" in e.get("name", "") for e in events)
    ref_path = str(tmp_path / "jax")
    assert ref.trace_cycle(ref_path, iterations=3) == ref_path
    assert any(files for _, _, files in os.walk(ref_path))


def test_eager_switch_nests():
    assert not _graph._eager
    with _graph.eager():
        with _graph.eager():
            assert _graph._eager
        assert _graph._eager
    assert not _graph._eager


def test_cache_is_eager_off_the_card():
    cache = _graph.Cache()
    prog = cache.program(("cg",), torch.device("cpu"))
    assert not prog.captured and cache.programs == {}
    assert not cache.transient(torch.device("cpu")).captured
