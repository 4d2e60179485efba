"""The captured solve (``pyamg_tpu_torch/_graph.py``) on the CPU.

A CUDA graph exists only on the card.  Here a stand-in takes its place
(``torch_stand_in.py``): its capture runs the step once as the card
records it, with every host read of a tensor and every host-to-device
copy made to raise (a tensor made from host data, a Python number
written into a tensor), then puts the state back as it found it; its
replay runs the step again; its device loop runs the WHILE, IF and
SWITCH nodes.  So the captured programs' own code runs here: the warm-up
into static tensors, the copies, the recorded launch bookkeeping.

* The bookkeeping: a stand-in wrapper's launches count once in the
  warm-up, not in the capture, and once more on every replay.
* Every step reads nothing on the host, for every cycle (V, W, F, AMLI),
  every coarse solver of ``test_torch_cycles.py``, every smoother of
  ``test_torch_relaxation.py`` and the double-single outer step; and each
  captured solve, run twice (warm-up and capture, then replays), equals
  the op-by-op solve (``_graph.eager()``) bit for bit.
* A Switch runs the branch of its index, and a device loop counts each
  branch's launches by the trips the device ran it.
* A device-stopped solve reads the host once, for standalone cycling and
  every Krylov method of ``solve``, and equals the op-by-op one at loop
  limits of 0, 1 and 2; the methods that run to the limit there do so as
  the JAX package's do.
* The loops equal the JAX package's: every Krylov method of
  ``krylov.__all__`` and standalone cycling on its 32^2 hierarchy
  (``hierarchy_from_arrays``; iterations,
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
from torch_stand_in import _REAL, _stand_in_program

torch.set_num_threads(1)

_FIXTURES = (port, ref, restore_coarse, reference_solve)


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
    calls, holder = [], _Holder()

    def kind(counts):
        calls.append(dict(counts))

    def wrapper(x, key):
        """A kernel wrapper's stand-in: reserves before and counts each
        launch."""
        _graph.ahead(holder, 3)
        _graph.tally(kind, key)
        return 2 * x

    prog = _stand_in_program()
    prog.put("x", torch.ones(4))

    def step(s):
        return {"y": wrapper(wrapper(wrapper(s["x"], "a"), "b"), "a")}

    prog.run("three", step)       # the warm-up counts, the capture records
    assert calls == [{"a": 1}, {"b": 1}, {"a": 1}]
    assert holder.taken == [3, 3, 3]
    # the three reservations and one tally of the kind
    hooks = prog.graphs["three"][1]
    assert len(hooks) == 4 and \
        sum(isinstance(h, _graph._Tally) for h in hooks) == 1
    for k in range(3):
        prog.put("x", torch.full((4,), float(k)))
        prog.run("three", step)
        assert torch.equal(prog.state["y"], torch.full((4,), 8.0 * k))
        # one call a replay for the graph's launches of the kind
        assert calls[3 + k:] == [{"a": 2, "b": 1}]
        assert holder.taken[3 + 3 * k:] == [3, 3, 3]
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
    def kind(counts):
        log.extend(tag for tag, n in counts.items() for _ in range(n))

    def wrapper(tag, x):
        _graph.ahead(holder, 3)
        _graph.tally(kind, tag)
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


@pytest.mark.parametrize("trips", [1, 7, 50])
def test_a_device_loop_adds_each_step_count_once_times_its_trips(trips):
    """After a device-stopped run, each tally a step recorded is one call
    of its kind with the step's counts times the trips the device made
    (independent of the trips), and the totals are the per-step form's
    and the op-by-op form's."""
    zero_i = torch.zeros((), dtype=torch.int32)

    def run(prog, form):
        calls = []

        def one(counts):
            calls.append(("one", dict(counts)))

        def two(counts):
            calls.append(("two", dict(counts)))

        def wrapper(kind, key, x):
            _graph.tally(kind, key)
            return x + 1

        def start(s):
            return {"x": s["x0"] * 1, "it": zero_i.clone(),
                    "stop": zero_i < 0}

        def first(s):
            y = wrapper(one, "p", wrapper(one, "q", wrapper(two, "r", s["x"])))
            return {"x": wrapper(one, "p", y)}

        def second(s):
            it = s["it"] + 1
            return {"x": wrapper(one, "p", s["x"]), "it": it,
                    "stop": it >= trips}

        prog.put("x0", torch.zeros(2))
        tree = [_graph.Step(prog, "start", start),
                _graph.While(prog, [_graph.Step(prog, "first", first),
                                    _graph.Step(prog, "second", second)],
                             100)]
        with form():
            got = prog.loop("t", tree, ("it", "x"))
        calls.clear()               # what the first run recorded and warmed
        with form():
            assert prog.loop("t", tree, ("it", "x")) == got
        assert got == [trips, [5.0 * trips] * 2]
        totals = {}
        for name, counts in calls:
            for key, n in counts.items():
                totals[(name, key)] = totals.get((name, key), 0) + n
        return calls, totals

    device, totals = run(_stand_in_program(), contextlib.nullcontext)
    # step "first", its tallies in the order recorded, then "second"
    assert device == [("two", {"r": trips}),
                      ("one", {"q": trips, "p": 2 * trips}),
                      ("one", {"p": trips})]
    assert totals == {("one", "p"): 3 * trips, ("one", "q"): trips,
                      ("two", "r"): trips}
    assert run(_stand_in_program(), _graph.per_step)[1] == totals
    assert run(_graph.Program(), contextlib.nullcontext)[1] == totals


def _switch_tree(prog, log, holder):
    """A loop of 5 trips (``it``) whose body is a Switch on the trip count
    over three branches (trip k runs branch k, trips 3 and 4 none) and a
    step raising the count; then a Switch on the final count over six
    branches, five empty (5: step Z).  Branch k's step counts its tag and
    reserves k + 1 units of ``holder`` a launch, Z 4."""
    zero_i = torch.zeros((), dtype=torch.int32)

    def kind(counts):
        log.extend(tag for tag, n in counts.items() for _ in range(n))

    def wrapper(tag, units, x):
        _graph.ahead(holder, units)
        _graph.tally(kind, tag)
        return x * 2 + units

    def start(s):
        return {"x": s["x0"] * 1, "it": zero_i.clone(), "stop": zero_i < 0}

    def branch(k):
        return [_graph.Step(prog, f"A{k}",
                            lambda s: {"x": wrapper(f"A{k}", k + 1, s["x"])})]

    def count(s):
        return {"it": s["it"] + 1}

    def z(s):
        return {"x": wrapper("Z", 4, s["x"])}

    return [_graph.Step(prog, "start", start),
            _graph.While(prog, [_graph.Switch(prog, "it", [branch(k) for k in
                                                           range(3)]),
                                _graph.Step(prog, "count", count)], 5),
            _graph.Switch(prog, "it", [[]] * 5 + [[_graph.Step(prog, "Z",
                                                               z)]])]


def test_a_switch_runs_the_branch_of_its_index():
    """A Switch runs the branch its index names (none out of range, an
    empty one too) in each form, and a device loop counts each branch's
    launches once for every trip the device ran it.  The branches of a
    Switch exclude each other, so it reserves for its largest: 3 units a
    trip for 5 trips, and 4 for Z's one (the warm-ups, launched for real,
    reserve their own)."""
    log, holder = [], _Holder()
    eager = _graph.Program()
    eager.put("x0", torch.ones(3))
    want = eager.loop("t", _switch_tree(eager, log, holder), ("it", "x"))
    # x = 1, then 2 x + 1, 2 x + 2, 2 x + 3 (A0-A2) and 2 x + 4 (Z)
    assert want[0] == 5 and want[1] == [42.0] * 3
    assert log == ["A0", "A1", "A2", "Z"] and holder.taken == [1, 2, 3, 4]
    prog = _stand_in_program()
    prog.put("x0", torch.ones(3))
    tree = _switch_tree(prog, log, holder)
    for form, taken in ((contextlib.nullcontext, [1, 2, 3, 4, 5 * 3 + 4]),
                        (contextlib.nullcontext, [5 * 3 + 4]),
                        (_graph.per_step, [1, 2, 3, 4])):
        log.clear()
        holder.taken.clear()
        with form():
            assert prog.loop("t", tree, ("it", "x")) == want
        assert sorted(log) == ["A0", "A1", "A2", "Z"]
        assert holder.taken == taken
    assert prog.captures == 6


def test_a_switch_needs_a_counter_the_host_knows():
    prog = _graph.Program()
    prog.put("k", torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="counter"):
        prog.loop("t", [_graph.Switch(prog, "k", [[]])])


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


GMRES_FAMILY = ("gmres", "fgmres", "gmres_mgs", "gmres_householder")
_READ_ACCELS = [None, "cg", "gmres", "fgmres", "gmres_householder",
                "gmres_mgs", "bicgstab", "cgne", "cgnr", "cr",
                "minimal_residual", "steepest_descent"]
_TO_THE_LIMIT = ("cgne", "cgnr", "minimal_residual")


@pytest.mark.parametrize("accel", _READ_ACCELS,
                         ids=["standalone"] + _READ_ACCELS[1:])
def test_device_stopped_solves_read_the_host_once(ref, accel, monkeypatch,
                                                  restore_coarse, captured):
    """A device-stopped solve reads the host once, at its end (the
    iterations, the flag, ``info`` and the history together); one graph
    a step reads once more a step (none once the steps reach the limit)
    and once after ``start`` (GMRES: and once for its restart loop)."""
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
    its = len(res) - 1
    # CGNE, CGNR and minimal residual run to the limit here, as the JAX
    # package's do; every other method converges
    assert its > 2 and (its == 40 and info == 40 if accel in _TO_THE_LIMIT
                        else info == 0)
    stops = its + 1 if its < 40 else its
    assert reads == {"device": 1, "per step": stops + 1 +
                     (accel in GMRES_FAMILY)}


@pytest.mark.parametrize("accel", _TO_THE_LIMIT)
def test_methods_at_the_limit_match_reference(ref, accel, restore_coarse,
                                              captured):
    """The methods that run to the limit in the host-read test do so as the
    JAX package's do on the same hierarchy and b: ``info`` 40, the history
    and x within 1e-8 relative."""
    ml = _with_coarse(ref, "pinv")
    b = _vec(17, ml.levels[0].A.shape[0])
    want_res = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, want_info = ref.solve(jnp.asarray(b), tol=1e-8, maxiter=40,
                                    accel=accel, residuals=want_res,
                                    return_info=True)
    got, info, res = _solve(ml, b, accel=accel, tol=1e-8, maxiter=40)
    assert info == want_info == 40 and len(res) == len(want_res) == 41
    _close(res, want_res, 1e-8)
    _close(got, want, 1e-8)


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
@pytest.mark.parametrize("accel", [None, "cg", "ds", "gmres", "fgmres",
                                   "gmres_householder", "gmres_mgs",
                                   "bicgstab", "cgne", "cgnr", "cr",
                                   "minimal_residual", "steepest_descent"])
def test_device_stopped_solves_at_the_smallest_limits(accel, maxiter,
                                                      captured):
    """Loops of 0, 1 and 2 trips at most (GMRES: a restart of 0, 1 and 2
    steps): the device-stopped solve (whose first run warms up every step
    of its tree, each from the state before it) equals the op-by-op one,
    twice."""
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
    # GMRES and FGMRES: init, begin, the product, three Arnoldi steps, the
    # updates of 0-3 steps, final (every branch of a switch is recorded
    # before the first device-stopped solve); each cycle apart
    assert ml._graphs().captured()[0] == 4 * (2 + 3 + 11 + 11)


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
    {}, {"cycle": "W"}, {"cycle": "AMLI"}] + [
    {"accel": m} for m in ("bicgstab", "cgne", "cgnr", "cr",
                           "minimal_residual", "steepest_descent",
                           "gmres_mgs", "gmres_householder")], ids=str)
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
    # the default points, 50 cycles apart: a gap of a few cycles lies
    # within the spread of the best-of-3 walls on a loaded host
    kept = dict(port._graphs().programs)
    t = port.profile_cycle("W")
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
