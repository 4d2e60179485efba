"""K2's launch geometry (``ops/dia_kernels.gs_geometry``), replayed on
the CPU.

For the main paths' DIA operators (500^2 levels 0 and 1, 64^3 A0), the
2048^2 operator that ``chip_smoke.py`` holds in the regime that reads the
band each pass, and small shapes: the blocks' row ranges cover [0, n)
exactly once, shared memory fits, every block waits for every block its
halo reaches, and a launch shape is one the CUDA entry point accepts.

The staged regime's tagged words are replayed under random schedules: a
block polls the rows ``staged_reads`` gives, and may run ahead of blocks
that do not read its rows.  No block may find a word overwritten by a
later pass before it read it (the kernel would spin on it), and no
schedule may deadlock; with one-sided bands and four passes or more.

Then the blocked sweep is emulated in torch: in each pass a block reads
its own rows and, as of the previous pass, the rows it polls (staged) or
those of the blocks it waits for (device), and NaN from every other row.
The result must equal ``dia_gs_sweep_plain`` bit for bit.

The Ruge-Stuben path on 2-D Poisson 500^2 runs K2 on bands no SA path
has: its DIA levels are built here at full size from the port's own
hierarchy, and their launch shapes checked; level 1 (125,000 rows, 11
diagonals reaching 500 rows) runs staged, and level 2 (31,371 rows, 23
diagonals reaching 376 rows, past a block of the staged regime) reads the
band each pass.  Both bands' tagged words are replayed (level 2's in a
staged shape the kernel would run all the same), and both blocked sweeps
emulated at their launch shapes with the levels' own colors and order.
"""

import functools

import numpy as np
import pytest
import torch

from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.classical import ruge_stuben_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gs_order,
                                                   make_coloring)
from pyamg_tpu_torch.sparse.matrix import DIA, DIA_TILE, dia_from_ell

torch.set_num_threads(1)

# (n, ndiag, halo) of the DIA operators chip_smoke.py runs K2 on
SHAPES = {"500^2 level 0": (250_000, 5, 500),
          "500^2 level 1": (27_889, 9, 168),
          "64^3 A0": (262_144, 7, 4096),
          "2048^2": (4_194_304, 5, 2048)}


def _check_shape(g, n, ndiag, halo, itemsize, max_smem=dk.MAX_SMEM):
    starts = [g.row_range(k, n) for k in range(g.blocks)]
    assert starts[0][0] == 0 and starts[-1][1] == n
    assert all(a < e for a, e in starts)                # no empty block
    assert all(starts[k][1] == starts[k + 1][0] for k in range(g.blocks - 1))
    assert 32 <= g.threads <= dk.MAX_THREADS and g.threads % 32 == 0
    assert g.halo == halo
    assert dk.gs_smem(g.staged, g.rows, ndiag, halo, itemsize) == g.smem
    assert g.smem <= max_smem or not g.staged
    assert g.halo <= g.rows or not g.staged     # reaches the next block only
    assert g.blocks <= dk.FLAG_BLOCKS
    assert g.reach * g.rows >= halo or g.reach == g.blocks - 1
    # every row a block's halo reaches lies in a block it waits for
    for k in range(g.blocks):
        a, e = g.row_range(k, n)
        need = {j for j in range(g.blocks)
                if j != k and g.row_range(j, n)[0] < min(n, e + halo)
                and g.row_range(j, n)[1] > max(0, a - halo)}
        assert need <= set(g.waits_for(k))


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(SHAPES))
def test_main_path_geometry(name, itemsize):
    n, ndiag, halo = SHAPES[name]
    g = dk.gs_geometry(n, ndiag, halo, itemsize)
    _check_shape(g, n, ndiag, halo, itemsize)
    # 2048^2 does not fit; 64^3 A0's halo of 4096 rows reaches three
    # blocks a side
    assert g.staged == (name not in ("2048^2", "64^3 A0"))
    # one block per SM
    assert dk.SM_COUNT - 8 <= g.blocks <= dk.SM_COUNT
    if name == "64^3 A0":
        assert g.reach == 3


@pytest.mark.parametrize("sms", [1, 3, 8, 132])
@pytest.mark.parametrize("n, ndiag, halo", [
    (1, 1, 0), (31, 3, 1), (2304, 5, 48), (256, 9, 17), (4096, 7, 256),
    (100_000, 80, 9000)])
def test_small_geometry(n, ndiag, halo, sms):
    for itemsize in (4, 8):
        for max_smem in (dk.MAX_SMEM, 1024):
            g = dk.gs_geometry(n, ndiag, halo, itemsize, sms, max_smem)
            _check_shape(g, n, ndiag, halo, itemsize, max_smem)
            assert g.blocks <= sms


def _reads_own_reach(offsets, lo, hi, halo, n):
    """The rows a staged block would poll if it polled only the rows its
    own diagonals reach (without their negation)."""
    spans = []
    for off in offsets:
        for s, t in ((max(lo + off, lo - halo), min(hi + off, lo)),
                     (max(lo + off, hi), min(hi + off, hi + halo))):
            if max(s, 0) < min(t, n):
                spans.append((max(s, 0), min(t, n)))
    return spans


def _replay_words(g, offsets, n, n_order, rng, reads=dk.staged_reads):
    """Replay a staged launch's tagged words under a random schedule: a
    ready block (every word it polls holds the pass it waits for) reads
    them, does its pass and publishes its rows in the other buffer.  Fails
    if a block finds a word that a later pass overwrote, or if no block is
    ready before all are done."""
    ranges = [g.row_range(k, n) for k in range(g.blocks)]
    polls = []
    for k, (lo, hi) in enumerate(ranges):
        blocks = set()
        for s, t in reads(offsets, lo, hi, g.halo, n):
            for j in range(s // g.rows, (t - 1) // g.rows + 1):
                a, e = ranges[j]
                # only the rows within the halo of a block's edges are
                # published: none of its interior is polled
                assert j != k and max(s, a, a + g.halo) >= \
                    min(t, e, e - g.halo)
                blocks.add(j)
        polls.append(sorted(blocks))
    tag = [[-1, -1] for _ in ranges]   # the pass of each buffer's words
    p = [0] * g.blocks
    while min(p) < n_order:
        ready = []
        for k in range(g.blocks):
            if p[k] == n_order:
                continue
            seen = [tag[j][p[k] & 1] for j in polls[k]] if p[k] else []
            assert all(t <= p[k] for t in seen), \
                f"block {k} finds pass {p[k]}'s words overwritten"
            if all(t == p[k] for t in seen):
                ready.append(k)
        assert ready, f"no block can go on at passes {p}"
        k = ready[rng.integers(len(ready))]
        if p[k] < n_order - 1:
            tag[k][(p[k] + 1) & 1] = p[k] + 1
        p[k] += 1


# one-sided and lopsided bands, and the main paths' symmetric ones
PROTOCOL_BANDS = [(-4096, -64, -1, 0), (0, 1, 64, 4096), (-7, 0, 1, 300),
                  (-300, -1, 0, 20), (-1, 0, 1), (-500, -1, 0, 1, 500),
                  (-4096, -64, -1, 0, 1, 64, 4096)]


@pytest.mark.parametrize("offsets", PROTOCOL_BANDS)
@pytest.mark.parametrize("n_order", [3, 5, 7])
def test_staged_words_never_overwritten_before_read(offsets, n_order):
    rng = np.random.default_rng(n_order)
    halo = max(abs(o) for o in offsets)
    for n, blocks in ((60_000, 132), (9_000, 13), (40_000, 40),
                      (400_000, 132)):
        # staged shapes gs_geometry gives, and ones it leaves to the
        # device regime (the halo past the next block), which the kernel
        # runs all the same
        g = dk._gs_shape(n, blocks, len(offsets), halo, 4, True)
        assert g.blocks > 2
        for _ in range(4):
            _replay_words(g, offsets, n, n_order, rng)


@pytest.mark.parametrize("offsets", [(-4096, -64, -1, 0), (0, 1, 64, 4096)])
def test_replay_catches_reads_that_do_not_wait_both_ways(offsets):
    """Polling only the rows its own diagonals reach lets a block run two
    passes ahead of a block that reads its rows; the replay sees it."""
    g = dk._gs_shape(60_000, 132, len(offsets), 4096, 4, True)
    rng = np.random.default_rng(0)
    with pytest.raises(AssertionError, match="overwritten"):
        for _ in range(20):
            _replay_words(g, offsets, 60_000, 5, rng, _reads_own_reach)


def test_staged_wait_relation_is_symmetric():
    """Block k polls a row of block j exactly when j polls a row of k."""
    for offsets in PROTOCOL_BANDS:
        halo = max(abs(o) for o in offsets)
        g = dk._gs_shape(60_000, 132, len(offsets), halo, 4, True)
        polls = set()
        for k in range(g.blocks):
            lo, hi = g.row_range(k, 60_000)
            for s, t in dk.staged_reads(offsets, lo, hi, halo, 60_000):
                polls |= {(k, j) for j in range(s // g.rows,
                                                (t - 1) // g.rows + 1)}
        assert polls == {(j, k) for k, j in polls}, offsets


def _band(n, offsets, seed):
    """A diagonally dominant DIA of random entries on ``offsets``, with 4
    random colors: (name, DIA, colors, ncolors, Dinv)."""
    rng = np.random.default_rng(seed)
    npad = -(-n // DIA_TILE) * DIA_TILE
    data = np.zeros((len(offsets), npad), np.float32)
    data[:, :n] = rng.standard_normal((len(offsets), n))
    data[offsets.index(0), :n] = 4.0
    colors = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32))
    return (f"band {offsets}", DIA(torch.as_tensor(data), offsets, (n, n)),
            colors, 4, torch.full((n,), 0.25))


def _operators():
    """(name, DIA, colors, ncolors, Dinv) at 48^2 levels 0 and 1 of the
    grid-SA hierarchy and a 16^3 7-point operator."""
    ml = smoothed_aggregation_solver(poisson((48, 48)).astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ops = [(f"48^2 level {i}", lvl.A) for i, lvl in enumerate(ml.levels[:2])]
    ops.append(("16^3", poisson((16, 16, 16)).astype(np.float32)))
    out = []
    for name, A in ops:
        colors, nc = make_coloring(A)
        out.append((name, dia_from_ell(A).to("cpu"), torch.as_tensor(colors),
                    nc, torch.as_tensor(dinv_vec(A))))
    out.append(_band(2304, (-200, -48, -1, 0), 1))
    out.append(_band(2304, (-7, 0, 1, 150), 2))
    return out


@pytest.fixture(scope="module")
def operators():
    return _operators()


def _emulate(g, D, x, b, Dinv, colors, order, omega):
    """The blocked sweep of geometry g: each block updates its rows from
    the x it can see after the previous pass (NaN where it may not)."""
    n = D.shape[0]
    cur = x.clone()
    for c in order:
        new = torch.empty_like(cur)
        for k in range(g.blocks):
            lo, hi = g.row_range(k, n)
            view = torch.full_like(cur, float("nan"))
            view[lo:hi] = cur[lo:hi]
            if g.staged:        # only the rows it polls
                for a, e in dk.staged_reads(D.offsets, lo, hi, g.halo, n):
                    view[a:e] = cur[a:e]
            for j in () if g.staged else g.waits_for(k):
                a, e = g.row_range(j, n)
                view[a:e] = cur[a:e]
            new[lo:hi] = dk.dia_gs_sweep_plain(
                D.data, D.offsets, n, view, b, Dinv, colors, [c],
                omega)[lo:hi]
        cur = new
    return cur


@pytest.mark.parametrize("op", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_sweep_equals_plain(operators, op, omega, dtype):
    name, D, colors, nc, Dinv = operators[op]
    n = D.shape[0]
    D = type(D)(D.data.to(dtype), D.offsets, D.shape)
    Dinv = Dinv.to(dtype)
    rng = np.random.default_rng(op)
    x = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    b = torch.as_tensor(rng.standard_normal(n), dtype=dtype)
    order = gs_order(nc, "symmetric", 1, omega)
    want = dk.dia_gs_sweep_plain(D.data, D.offsets, n, x, b, Dinv, colors,
                                 order, omega)
    halo = max(abs(o) for o in D.offsets)
    itemsize = D.data.element_size()
    shapes = set()
    for sms in (2, 5, 13, 132):
        for max_smem in (dk.MAX_SMEM, 1024):
            shapes.add(dk.gs_geometry(n, len(D.offsets), halo, itemsize, sms,
                                      max_smem))
    # a staged shape whose halo reaches past the next block
    shapes.add(dk._gs_shape(n, 40, len(D.offsets), halo, itemsize, True))
    assert any(g.blocks > 1 and g.staged for g in shapes)
    assert any(g.blocks > 1 and not g.staged for g in shapes)
    for g in shapes:
        got = _emulate(g, D, x, b, Dinv, colors, order, omega)
        assert torch.equal(got, want), (name, g)


# -- the Ruge-Stuben 500^2 path's DIA levels ----------------------------------

# (n, ndiag, halo) of its DIA levels but the coarsest, and whether K2 runs
# staged there
RS_SHAPES = {0: (250_000, 5, 500, True), 1: (125_000, 11, 500, True),
             2: (31_371, 23, 376, False), 5: (509, 25, 48, True),
             6: (120, 29, 24, True), 7: (29, 25, 12, True)}


@functools.cache
def _rs_levels():
    ml = ruge_stuben_solver(poisson((500, 500)).astype(np.float32))
    return ml.compress_stencils().levels


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("level", list(RS_SHAPES))
def test_rs_path_geometry(level, itemsize):
    lvl = _rs_levels()[level]
    n, ndiag, halo, staged = RS_SHAPES[level]
    assert isinstance(lvl.A, DIA) and (lvl.A.shape[0], len(lvl.A.offsets),
                                       max(map(abs, lvl.A.offsets))) == \
        (n, ndiag, halo)
    g = dk.gs_geometry(n, ndiag, halo, itemsize)
    _check_shape(g, n, ndiag, halo, itemsize)
    assert g.staged == staged


@pytest.mark.parametrize("n_order", [7, 9])
@pytest.mark.parametrize("level", [1, 2])
def test_rs_path_staged_words(level, n_order):
    D = _rs_levels()[level].A
    n, halo = D.shape[0], max(abs(o) for o in D.offsets)
    g = dk.gs_geometry(n, len(D.offsets), halo, 4)
    if not g.staged:
        g = dk._gs_shape(n, g.blocks, len(D.offsets), halo, 4, True)
    rng = np.random.default_rng(level)
    for _ in range(3):
        _replay_words(g, D.offsets, n, n_order, rng)


@pytest.mark.parametrize("level", [1, 2])
def test_rs_path_blocked_sweep_equals_plain(level):
    """Symmetric Gauss-Seidel with the level's colors and color order, at
    the launch shape of the card (132 SMs), float32."""
    lvl = _rs_levels()[level]
    _, sopts, params = lvl.pre
    D = lvl.A.to("cpu")
    n = D.shape[0]
    colors = torch.as_tensor(params["colors"])
    Dinv = torch.as_tensor(params["Dinv"])
    order = gs_order(sopts["ncolors"], sopts["sweep"], sopts["iterations"],
                     sopts["omega"])
    rng = np.random.default_rng(level)
    x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    want = dk.dia_gs_sweep_plain(D.data, D.offsets, n, x, b, Dinv, colors,
                                 order, 1.0)
    g = dk.gs_geometry(n, len(D.offsets), max(abs(o) for o in D.offsets), 4)
    assert g.staged == RS_SHAPES[level][3]
    assert torch.equal(_emulate(g, D, x, b, Dinv, colors, order, 1.0), want)
