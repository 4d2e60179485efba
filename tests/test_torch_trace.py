"""The port's store of spans and counters (``pyamg_tpu_torch/_trace.py``)
and the spans and counters the program records in it, on the CPU."""

import contextlib
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyamg_tpu_torch import _graph, _trace
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.parallel import dist_setup as pd
from pyamg_tpu_torch.parallel import partition as pt

from torch_stand_in import _stand_in_program

torch.set_num_threads(1)

STENCIL = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)


@pytest.fixture(autouse=True)
def store():
    """A store emptied for each test, its ring at the default bound."""
    _trace.reset(ring=_trace.RING)
    yield
    _trace.reset(ring=_trace.RING)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


# -- the store ---------------------------------------------------------------

@_trace.entry
def _entry(inner=None):
    with _trace.span("outer", k=1):
        with _trace.span("inner"):
            if inner is not None:
                inner()


def test_spans_nest_with_parents_and_one_solve_id():
    with _trace.recording():
        _entry(inner=_entry)       # an entry inside an entry opens no root
        _entry()
    spans = _by_name(_trace.snapshot()["spans"])
    roots = spans["solve"]
    assert len(roots) == 2 and all(r["parent"] is None for r in roots)
    assert roots[0]["attrs"] == {"entry": "_entry"}
    assert roots[0]["solve"] == roots[0]["id"] != roots[1]["solve"]
    by_id = {s["id"]: s for v in spans.values() for s in v}
    assert len(spans["outer"]) == len(spans["inner"]) == 3
    for s in spans["inner"]:
        parent = by_id[s["parent"]]
        assert parent["name"] == "outer" and parent["attrs"] == {"k": 1}
        assert by_id[parent["parent"]]["name"] in ("solve", "inner")
        assert parent["start"] <= s["start"] <= s["end"] <= parent["end"]
    # every span of a call carries its root's id
    first = [s for v in spans.values() for s in v
             if s["solve"] == roots[0]["id"]]
    assert len(first) == 5


def test_totals_and_counters_are_always_on():
    for form in ("a", "a", "b"):
        with _trace.span("x", form=form):
            pass
    s = _trace.span("y")
    s.close()
    s.close()                      # a second close adds nothing
    _trace.count("c")
    _trace.count("c", 4)
    assert _trace.add("z", 10, 35, level=2) == 25
    snap = _trace.snapshot()
    t = snap["totals"]
    assert t["x"]["n"] == 3 and t["x[a]"]["n"] == 2 and t["x[b]"]["n"] == 1
    assert t["x"]["ns"] == t["x[a]"]["ns"] + t["x[b]"]["ns"]
    assert t["y"] == {"n": 1, "ns": s.ns} and s.seconds == s.ns / 1e9
    assert t["z"] == {"n": 1, "ns": 25}
    assert snap["counters"] == {"c": 5}
    assert snap["spans"] == [] and snap["clock"] == "perf_counter_ns"
    _trace.reset()
    assert _trace.snapshot()["totals"] == {}
    assert _trace.snapshot()["counters"] == {}


def test_the_ring_keeps_the_newest_spans_to_its_bound():
    _trace.reset(ring=3)
    with _trace.recording():
        for k in range(5):
            with _trace.span("s", k=k):
                pass
    spans = _trace.snapshot()["spans"]
    assert [s["attrs"]["k"] for s in spans] == [2, 3, 4]
    assert _trace.snapshot()["totals"]["s"]["n"] == 5


@pytest.mark.parametrize("on", ["none", "recording", "profiler"])
def test_spans_are_kept_only_while_recording_or_profiled(on):
    from torch.profiler import ProfilerActivity, profile
    ctx = {"none": contextlib.nullcontext(),
           "recording": _trace.recording(),
           "profiler": profile(activities=[ProfilerActivity.CPU])}[on]
    with ctx:
        with _trace.span("kept"):
            pass
    with _trace.span("after"):
        pass
    names = [s["name"] for s in _trace.snapshot()["spans"]]
    assert names == ([] if on == "none" else ["kept"])


def test_profiled_spans_share_the_device_traces_clock():
    """Each span's interval and its ``pyamg_tpu_torch::`` range in a CPU
    profile differ by one constant offset, to within 50 us."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k, ms in enumerate((1, 4, 2, 6)):
            with _trace.span(f"clock{k}"):
                time.sleep(ms / 1e3)
            time.sleep(0.002)
    mine = {s["name"]: s for s in _trace.snapshot()["spans"]}
    offsets = []
    for e in prof.events():
        if e.name.startswith(_trace.PREFIX):
            s = mine[e.name[len(_trace.PREFIX):]]
            offsets.append(s["start"] / 1e3 - e.time_range.start)
            offsets.append(s["end"] / 1e3 - e.time_range.end)
    assert len(offsets) == 8
    assert max(offsets) - min(offsets) < 50.0, offsets


# -- the program's spans and counters -----------------------------------------

@pytest.fixture(scope="module")
def grid40():
    A64 = poisson((40, 40))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=64, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    return ml


def test_a_refined_solve_is_one_tree_with_four_transfers(grid40):
    b = np.random.default_rng(3).standard_normal(1600)
    with _trace.recording():
        x = grid40.solve_refined_device(b)
    assert x.dtype == np.float64
    snap = _trace.snapshot()
    spans = snap["spans"]
    root = spans[-1]
    assert root["name"] == "solve" and root["parent"] is None
    assert root["attrs"] == {"entry": "MultilevelSolver.solve_refined_device"}
    children = [s for s in spans if s["parent"] == root["id"]]
    assert [s["name"] for s in children] == ["solve.b_in", "graph.read",
                                             "solve.x_out"]
    assert children[1]["attrs"] == {"form": "device"}
    assert all(s["solve"] == root["id"] for s in spans)
    # b's two halves in, the one read, x's pair out
    assert snap["counters"] == {"host_transfers": 4}
    assert snap["totals"]["graph.read[device]"]["n"] == 1


@pytest.mark.parametrize("accel", [None, "cg", "gmres"])
def test_solve_counts_its_handoffs(grid40, accel):
    """``solve`` takes b from the host (one transfer) and reads its loop
    once; x stays on the device.  A tensor already on a card would cross
    nothing; the CPU counts as the card would."""
    b = np.random.default_rng(4).standard_normal(1600).astype(np.float32)
    x = grid40.solve(b, tol=1e-6, maxiter=20, accel=accel)
    assert isinstance(x, torch.Tensor)
    snap = _trace.snapshot()
    assert snap["counters"]["host_transfers"] == 2
    assert snap["totals"]["solve"]["n"] == 1
    for name in ("solve.b_in", "graph.read", "solve.x_out"):
        assert snap["totals"][name]["n"] == 1


def _bell_counts():
    from pyamg_tpu_torch.ops import bell_kernels as bk
    c = _trace.snapshot()["counters"]
    shapes = {k: v for k, v in c.items() if k.startswith("bell.products[")}
    return c.get("bell.products", 0), c.get("bell.gs_passes", 0), shapes, \
        c.get("bell_kernels.launches", 0), dict(bk.bell_apply.by_op)


@pytest.fixture(scope="module")
def elasticity24():
    from pyamg_tpu_torch.gallery import linear_elasticity
    A64, B = linear_elasticity((24, 24))
    ml = smoothed_aggregation_solver(A64.astype(np.float32), B=B,
                                     max_coarse=50)
    ml.compress_stencils()
    ml.collapse_coarse(max_n=100, device="cpu")
    ml.enable_ds_refinement(A64, device="cpu")
    ml.to_device("cpu")
    return ml


def test_block_products_and_passes_count_once_a_replay(elasticity24):
    """A captured solve's replay counts the block products (each by its
    shape, the sum in ``bell.products``), the block Gauss-Seidel color
    passes and K7's launches (each by mode and shape in
    ``bell_apply.by_op``, the sum in ``bell_kernels.launches``) that an
    op-by-op solve of the same b
    counts, in the same iterations: one V-cycle a CG iteration and one a
    correction, each a residual, a restriction and a prolongation (full
    products) and 4 x (colors) color passes (a pass computes its color's
    rows alone: no full product) on each level above the dense tail, and
    one product with A a CG iteration, one a correction and one every 8th
    iteration; every product and every pass one K7 launch."""
    from torch_stand_in import stand_in_programs
    ml = elasticity24
    b = np.random.default_rng(9).standard_normal(ml.levels[0].A.shape[0])

    def counted(run):
        from pyamg_tpu_torch.ops import launch
        _trace.reset()
        launch.reset_launch_counts()
        it = {}
        with run():
            ml.solve_refined_device(b, inner_maxiter=60, max_outer=20,
                                    iterations_out=it)
        return _bell_counts(), it

    eager, it = counted(_graph.eager)
    with stand_in_programs():
        ml.solve_refined_device(b, inner_maxiter=60, max_outer=20)
        replay, it2 = counted(contextlib.nullcontext)
    assert replay == eager and it2 == it
    products, passes, shapes, launches, by_mode = eager
    assert sum(shapes.values()) == products
    assert sum(by_mode.values()) == launches == passes + products
    assert sum(v for k, v in by_mode.items() if k[0] == "gs_color") == \
        passes
    active = ml.levels[:-1]
    colors = [lvl.pre[1]["ncolors"] for lvl in active]
    cycles = it["outer"] + it["inner"]
    assert passes == cycles * sum(4 * c for c in colors)
    extra = products - cycles * 3 * len(active)
    assert cycles <= extra <= cycles + it["inner"] // 8


def test_solve_refined_nests_its_inner_solves(grid40):
    """``solve_refined`` is one root; each inner ``solve`` adds its b in
    and its read, and each correction comes back once."""
    b = np.random.default_rng(5).standard_normal(1600)
    it = {}
    grid40.solve_refined(b, tol=1e-9, iterations_out=it)
    snap = _trace.snapshot()
    k = it["outer"]
    assert k >= 1 and snap["totals"]["solve"]["n"] == 1
    assert snap["totals"]["solve.x_out"]["n"] == 2 * k
    assert snap["counters"]["host_transfers"] == 3 * k


def test_prep_and_setup_phases_are_spans():
    A64 = poisson((24, 24))
    with _trace.recording():
        ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                         aggregate=("grid", {}),
                                         max_coarse=10)
        built = len(ml.levels)
        ml.compress_stencils()
        ml.collapse_coarse(max_n=64, device="cpu")
        ml.enable_ds_refinement(A64, device="cpu")
        ml.to_device("cpu")
    snap = _trace.snapshot()
    for step in ("compress_stencils", "collapse_coarse",
                 "enable_ds_refinement", "to_device"):
        assert snap["totals"]["prep." + step]["n"] == 1
    # setup_timings() keeps its keys and sums the store's setup.<phase>
    timings = ml.setup_timings()
    assert set(timings) == {"strength", "aggregate", "improve_candidates",
                            "fit_candidates", "smooth_P", "transpose_R",
                            "rap"}
    phases = [s for s in snap["spans"] if s["name"].startswith("setup.")]
    assert {s["attrs"]["level"] for s in phases} == set(range(built - 1))
    # the levels the collapse kept above the dense tail
    kept = len(ml.levels) - 1
    for key, sec in timings.items():
        ns = sum(s["end"] - s["start"] for s in phases
                 if s["name"] == "setup." + key and s["attrs"]["level"] < kept)
        assert sec == pytest.approx(ns / 1e9, rel=1e-9, abs=1e-12)


def test_captures_and_their_seconds_come_from_spans():
    prog = _stand_in_program()
    prog.put("x", torch.ones(4))
    for name in ("a", "b"):
        prog.run(name, lambda s: {"y": 2 * s["x"]})
        prog.run(name, lambda s: {"y": 2 * s["x"]})     # a replay
    t = _trace.snapshot()["totals"]
    assert prog.captures == 2 == t["graph.capture"]["n"]
    assert t["graph.step"]["n"] == 2 and t["graph.warm"]["n"] == 2
    assert _trace.snapshot()["counters"]["graph.recorded"] == 2
    assert prog.capture_s == pytest.approx(
        (t["graph.warm"]["ns"] + t["graph.capture"]["ns"]) / 1e9)
    cache = _graph.Cache()
    cache.programs["k"] = prog
    assert cache.captured() == (2, prog.capture_s)


def test_native_build_is_a_span(tmp_path, monkeypatch):
    import shutil
    from pyamg_tpu_torch._native import build
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.fail("g++ is required to build the port's host helpers")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    src = tmp_path / "two.c"
    src.write_text("int two(void) { return 2; }\n")
    cmd = [gxx, "-shared", "-fPIC"]
    with _trace.recording():
        built = build.shared_library(str(src), cmd, "two")
        found = build.shared_library(str(src), cmd, "two")
    spans = _trace.snapshot()["spans"]
    assert [s["attrs"] for s in spans] == [
        {"library": "two", "built": True},
        {"library": "two", "built": False}]
    assert built["seconds"] == (spans[0]["end"] - spans[0]["start"]) / 1e9
    assert found["seconds"] == 0.0 and found["path"] == built["path"]
    assert _trace.snapshot()["counters"] == {"native.builds": 1}


# -- the distributed set-up and solves ----------------------------------------

@pytest.fixture(scope="module")
def one_rank_group():
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield pt.make_row_mesh(1, device="cpu")
    if made:
        dist.destroy_process_group()


def _dist_setup(mesh, n, monkeypatch):
    """The SA set-up of Poisson n^2 on ``mesh``, recorded, and the Luby
    rounds it ran (each round takes the neighbour maximum 2 x dist
    times)."""
    calls = [0]
    real = pd._nb_max_global

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)
    monkeypatch.setattr(pd, "_nb_max_global", counted)
    c, v, o, nl = pd.dist_stencil_grid(STENCIL, (n, n), mesh,
                                       dtype=torch.float32)
    with _trace.recording():
        hier = pd.distributed_sa_setup(c, v, o, nl, mesh,
                                       coarsen_until=200)
    monkeypatch.setattr(pd, "_nb_max_global", real)
    return hier, calls[0] // 4


@pytest.mark.parametrize("mesh", ["ring", "stacked"])
def test_dist_setup_spans_each_level_and_luby_round(one_rank_group, mesh,
                                                    monkeypatch):
    m = one_rank_group if mesh == "ring" else pd.StackedMesh(2, "cpu")
    hier, rounds = _dist_setup(m, 40, monkeypatch)
    snap = _trace.snapshot()
    spans = _by_name(snap["spans"])
    levels = len(hier.levels)
    assert levels >= 3 and rounds >= levels - 1
    assert len(spans["dist_setup.mis_round"]) == rounds
    assert snap["totals"]["dist_setup.mis_round"]["n"] == rounds
    lv = spans["dist_setup.level"]
    assert [s["attrs"]["level"] for s in lv] == list(range(levels))
    assert hier.diagnostics["seconds"] == [
        (s["end"] - s["start"]) / 1e9 for s in lv]
    ids = {s["id"] for s in lv}
    assert all(s["parent"] in ids for s in spans["dist_setup.mis_round"])
    # a level: its margin, two reads of the power iteration, the MIS's
    # first read and one a round, the aggregates and the drops; then the
    # margin that stops the loop, the coarsest's margin and power iteration
    assert snap["counters"]["dist_setup.host_reads"] == \
        6 * (levels - 1) + rounds + 4


def test_dist_solve_cg_counts_two_transfers(one_rank_group, monkeypatch):
    hier, _ = _dist_setup(one_rank_group, 24, monkeypatch)
    _trace.reset()
    b = np.random.default_rng(6).standard_normal(24 * 24)
    with _trace.recording():
        x, relres, it = hier.solve_cg(b, tol=1e-6, maxiter=40)
    assert relres <= 1e-6 and x.shape == (24 * 24,)
    snap = _trace.snapshot()
    # the first solve builds the solve layout: one read a level
    assert snap["counters"] == {"host_transfers": 2,
                                "dist_setup.host_reads": _layouts(hier)}
    root = snap["spans"][-1]
    assert root["attrs"] == {"entry": "DistHierarchy.solve_cg"}
    assert [s["name"] for s in snap["spans"]
            if s["parent"] == root["id"]] == ["solve.b_in", "graph.read",
                                              "solve.x_out"]
    _trace.reset()
    hier.solve_cg(b, tol=1e-6, maxiter=40)
    assert _trace.snapshot()["counters"] == {"host_transfers": 2}


def _layouts(hier):
    """The levels whose products the solve layout holds: all but the
    coarsest, solved densely (level 0 always)."""
    return max(len(hier.levels) - 1, 1)


def test_dist_solve_fgmres_is_one_root(one_rank_group, monkeypatch):
    hier, _ = _dist_setup(one_rank_group, 24, monkeypatch)
    _trace.reset()
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(24 * 24))
    x, relres, _ = hier.solve_fgmres(b, tol=1e-6, restart=10, max_outer=5)
    assert relres <= 1e-6
    snap = _trace.snapshot()
    assert snap["totals"]["solve"]["n"] == 1
    assert snap["counters"] == {"host_transfers": 2,
                                "dist_setup.host_reads": _layouts(hier)}
