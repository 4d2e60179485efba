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

Across launches: K2's tagged words and pass counters outlive a launch,
and a CUDA graph replays its launches as it recorded them.  The exchange
memory is emulated over a sequence of launches (each block runs as far as
its waits let it, in block order): one recorded launch replayed twice,
with eager launches on a smaller operator between the replays.  With the
epoch read from device memory and raised by each launch (the kernel's
``ctl``), no stale word or counter is read and every launch equals
``dia_gs_sweep_plain`` bit for bit; with the epoch baked into the
recorded launch, the same sequence reads words and counters that the
previous replay or an eager launch left, in both regimes.

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

from pyamg_tpu_torch import _graph
from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.classical import ruge_stuben_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.relaxation.relaxation import (dinv_vec, gs_order,
                                                   make_coloring)
from pyamg_tpu_torch.sparse.matrix import DIA, DIA_TILE, dia_from_ell

torch.set_num_threads(1)

# (n, ndiag, halo) of the DIA operators chip_smoke.py runs K2 on; the
# 3163^2 levels are the scale: phase's 10M path (1055^2 on level 1)
SHAPES = {"500^2 level 0": (250_000, 5, 500),
          "500^2 level 1": (27_889, 9, 168),
          "64^3 A0": (262_144, 7, 4096),
          "2048^2": (4_194_304, 5, 2048),
          "3163^2 level 0": (10_004_569, 5, 3163),
          "3163^2 level 1": (1_113_025, 9, 1056)}
# the shapes whose band is read each pass: 64^3 A0's halo of 4096 rows
# reaches three blocks a side; the others' blocks do not fit in shared
# memory (3163^2 level 0: 75,808 rows a block, about 2.4 MB staged; level
# 1: 8,448 rows, about 490 KB)
BAND_EACH_PASS = {"64^3 A0", "2048^2", "3163^2 level 0", "3163^2 level 1"}


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
    assert g.staged == (name not in BAND_EACH_PASS)
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


# -- the exchange across launches: replayed epochs ---------------------------

class _Memory:
    """K2's exchange memory as launches leave it: the tagged words of the
    two buffers (row -> (tag, value, writer)), the pass counters (block ->
    value), the epoch in device memory (``ctl``), and each operator's x
    buffers of the regime that reads the band each pass (name -> buffer ->
    row -> (value, writer); a graph's buffers keep their addresses)."""

    def __init__(self):
        self.words = ({}, {})
        self.flags = {}
        self.epoch = 1
        self.x = {}


def _launch(mem, g, op, x0, b, order, omega, epoch, writer):
    """Emulate one K2 launch of geometry g on operator ``op`` (name, DIA,
    colors, Dinv) at ``epoch``: each block, in block order, runs every pass
    its waits allow; a staged block polls its words until their tag is
    ``epoch + pass``, a block of the other regime waits until each
    neighbour's counter has reached ``epoch + pass``.  Returns (x, the
    stale reads: words or rows that the launch took as its own but an
    earlier launch or pass wrote)."""
    name, D, colors, Dinv = op
    n, last = D.shape[0], len(order) - 1
    ranges = [g.row_range(k, n) for k in range(g.blocks)]
    cur = [x0[lo:hi].clone() for lo, hi in ranges]
    bufs = mem.x.setdefault(name, ({}, {}))
    done = [0] * g.blocks
    out = torch.empty_like(x0)
    stale = []

    def view_of(k, q):
        """The x block k computes pass q from, or None while it waits."""
        lo, hi = ranges[k]
        view = torch.full_like(x0, float("nan"))
        if g.staged:
            view[lo:hi] = cur[k]
            for a, e in dk.staged_reads(D.offsets, lo, hi, g.halo, n):
                for r in range(a, e):
                    if q == 0:
                        view[r] = x0[r]
                        continue
                    tag, value, who = mem.words[q & 1].get(r, (0, 0.0, None))
                    if tag != epoch + q:
                        return None
                    if who != (writer, q):
                        stale.append(("word", r, q))
                    view[r] = value
            return view
        if q == 0:
            return x0.clone()
        for j in g.waits_for(k):
            diff = (mem.flags.get(j, 0) - (epoch + q)) & 0xFFFFFFFF
            if diff >= 1 << 31:                 # signed: still behind
                return None
        src = bufs[(last - q + 1) & 1]
        for j in [k] + g.waits_for(k):
            a, e = ranges[j]
            for r in range(a, e):
                value, who = src.get(r, (0.0, None))
                if who != (writer, q - 1):
                    stale.append(("row", r, q))
                view[r] = value
        return view

    progress = True
    while min(done) <= last and progress:
        progress = False
        for k in range(g.blocks):
            while done[k] <= last:
                q = done[k]
                view = view_of(k, q)
                if view is None:
                    break
                lo, hi = ranges[k]
                new = dk.dia_gs_sweep_plain(D.data, D.offsets, n, view, b,
                                            Dinv, colors, [order[q]],
                                            omega)[lo:hi]
                cur[k] = new
                if q == last:
                    out[lo:hi] = new
                elif g.staged:
                    for r in range(lo, hi):
                        if r < lo + g.halo or r >= hi - g.halo:
                            mem.words[(q + 1) & 1][r] = (
                                epoch + q + 1, float(new[r - lo]),
                                (writer, q + 1))
                else:
                    dst = bufs[(last - q) & 1]
                    for r in range(lo, hi):
                        dst[r] = (float(new[r - lo]), (writer, q))
                    mem.flags[k] = epoch + q + 1
                done[k] += 1
                progress = True
    assert min(done) > last, f"no block can go on at passes {done}"
    return out, stale


def _replayed_sequence(staged, scheme, order):
    """A recorded launch on a 2304-row band replayed twice, with two eager
    launches on a 1152-row band between the replays, on one exchange.
    ``scheme``: 'device' (each launch reads and raises the epoch in
    device memory) or 'baked' (the recorded launch keeps the epoch the
    host gave it while it was recorded); ``order``: the color passes.
    Returns (every launch's x against the plain version, the stale
    reads)."""
    offsets = (-48, -1, 0, 1, 48)
    big, small = _band(2304, offsets, 3), _band(1152, offsets, 4)
    ops = {"big": big, "small": small}
    geo = {"big": dk._gs_shape(2304, 8, 5, 48, 4, staged),
           "small": dk._gs_shape(1152, 4, 5, 48, 4, staged)}
    mem = _Memory()
    host = [1]                       # the host's epoch (eager launches)

    def run(which, seed, recorded=None):
        _, D, colors, _, Dinv = ops[which]
        n = D.shape[0]
        rng = np.random.default_rng(seed)
        x0 = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
        b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
        if scheme == "device":
            epoch = mem.epoch
            mem.epoch += len(order) + 1
        elif recorded is not None:
            epoch = recorded
        else:
            epoch = host[0]
            host[0] += len(order) + 1
        got, stale = _launch(mem, geo[which], (which, D, colors, Dinv), x0,
                             b, order, 1.0, epoch, object())
        want = dk.dia_gs_sweep_plain(D.data, D.offsets, n, x0, b, Dinv,
                                     colors, order, 1.0)
        return torch.equal(got, want), stale

    results, stale = [], []
    run("big", 0)                    # the warm-up before the capture
    recorded = host[0]               # the epoch the capture would bake
    host[0] += len(order) + 1
    for seed in (1, 2):              # replay, eager, eager, replay
        for which, s, rec in (("big", seed, recorded),
                              ("small", 10 + seed, None),
                              ("small", 20 + seed, None)):
            ok, st = run(which, s, rec)
            results.append(ok)
            stale += st
    return results, stale


# a symmetric sweep of 2 colors (3 passes, as on 500^2 level 0) and of 4
ORDERS = ([0, 1, 0], [0, 1, 2, 3, 2, 1, 0])


@pytest.mark.parametrize("order", ORDERS, ids=len)
@pytest.mark.parametrize("staged", [True, False], ids=["staged", "device"])
def test_replayed_launches_read_no_stale_word_or_counter(staged, order):
    results, stale = _replayed_sequence(staged, "device", order)
    assert stale == [] and all(results)


@pytest.mark.parametrize("staged", [True, False], ids=["staged", "device"])
def test_baked_epochs_read_stale_words_and_counters(staged):
    """Without the epoch in device memory, the harness sees the hazard:
    the second replay takes the first replay's words (staged; with 3
    passes a word's last tag is one a replay polls for again) or passes
    counters an earlier launch raised (the other regime)."""
    _, stale = _replayed_sequence(staged, "baked", ORDERS[0])
    assert stale, "the harness did not see a stale read"


def test_exchange_starts_afresh_before_the_epoch_wraps():
    ex = dk._Exchange(torch.device("cpu"))
    assert ex.epoch == 1 and ex.ctl.tolist() == [1, 0]
    ex.words_for(16).fill_(7)
    ex.flags.fill_(5)
    ex.reserve(7)
    assert ex.epoch == 9 and ex.words.sum() > 0
    ex.epoch = dk.EPOCH_RESTART - 5
    ex.ctl[0] = 123
    ex.reserve(7)                      # reaches the restart: start afresh
    assert ex.epoch == 9 and ex.ctl.tolist() == [1, 0]
    assert not ex.words.any() and not ex.flags.any()


def test_a_restart_within_a_replay_keeps_the_device_below_2_32():
    """A replay reserves its launches one by one before it starts, and a
    restart among them sets the device's epoch to 1 before the whole
    replay: the device then runs ahead of the host's count by the passes
    reserved before the restart, at most one graph's, which the restart
    point leaves room for."""
    ex = dk._Exchange(torch.device("cpu"))
    passes = [3, 7, 1] * 400               # one graph's K2 launches
    total = sum(p + 1 for p in passes)
    ex.epoch = device = dk.EPOCH_RESTART - total // 2
    restarts = 0
    for _ in range(4):
        ex.ctl[0] = 5                      # the device's epoch, not 1
        for p in passes:
            ex.reserve(p)
        if int(ex.ctl[0]) == 1:            # restarted before the replay
            device, restarts = 1, restarts + 1
        device += total                    # what the replay's launches add
        assert device - ex.epoch <= total and device + total < 1 << 32
    assert restarts == 1


class _RecordedStep:
    """A step graph's stand-in: the capture runs the step to record its
    bookkeeping and puts the device's epoch back (a capture runs nothing
    on the card); a replay runs the step again, its bookkeeping dropped
    (the program applies what the capture recorded)."""

    def __init__(self, ex):
        self.ex = ex

    def capture(self, body):
        ctl = self.ex.ctl.clone()
        body()
        self.ex.ctl.copy_(ctl)
        self.body = body

    def replay(self):
        saved, _graph._recording = _graph._recording, []
        try:
            self.body()
        finally:
            _graph._recording = saved


class _DeviceLoop:
    """A device loop's stand-in: runs one While of steps as the card does
    (the flag and counter read here model the device)."""

    def __init__(self, nodes, tally, slots):
        self.nodes, self.tally, self.slots = nodes, tally, slots

    def launch(self):
        self.tally.zero_()
        start, loop = self.nodes
        start.prog.graphs[start.name][0].replay()
        st = loop.prog.state
        while not bool(st[loop.stop]) and int(st[loop.count]) < loop.limit:
            for step in loop.body:
                step.prog.graphs[step.name][0].replay()
            self.tally[self.slots[id(loop)]] += 1


def test_a_device_stopped_replay_keeps_the_host_epoch_at_or_above_the_device():
    """A device-stopped solve reserves, before its one replay, the epochs
    of the most trips its loop allows; the device's epoch then rises by
    the trips it ran, fewer.  Over replays of random lengths, one of them
    across the restart, the host's count stays at or above the device's
    epoch (in ``ctl``), which stays below 2**32."""
    cpu = torch.device("cpu")
    ex = dk._Exchange(cpu)
    passes, limit = (3, 7), 50
    prog = _graph.Graphs(cpu, None, None, graph_type=lambda pool:
                         _RecordedStep(ex), loop_type=_DeviceLoop)

    def start(s):
        zero = torch.zeros((), dtype=torch.int32)
        return {"it": zero, "stop": zero > 0}

    def trip(s):
        for p in passes:                   # two K2 launches
            _graph.ahead(ex, p + 1)
            ex.ctl[0] += p + 1             # each raises the device's epoch
        it = s["it"] + 1
        return {"it": it, "stop": it >= s["want"]}

    tree = [_graph.Step(prog, "start", start),
            _graph.While(prog, [_graph.Step(prog, "trip", trip)], limit)]
    most = limit * sum(p + 1 for p in passes)
    ex.epoch = dk.EPOCH_RESTART - 2 * most
    restarts = 0
    for want in np.random.default_rng(3).integers(1, limit + 1, 8):
        prog.put("want", torch.tensor(int(want), dtype=torch.int32))
        before = ex.epoch
        (trips,) = prog.loop("k2", tree, ("it",))
        restarts += ex.epoch < before
        device = int(ex.ctl[0])
        assert trips == want and ex.epoch >= device and device < 1 << 32
    assert restarts == 1


def test_outgrown_words_of_a_recorded_exchange_are_kept():
    """Growth after a capture frees no buffer a graph recorded: the
    exchange of a hierarchy's graphs keeps what its words outgrow and
    clears it on a restart; the stream's exchange lets it go."""
    ex = dk._Exchange(torch.device("cpu"), keep=True)
    small = ex.words_for(8)
    small.fill_(3)
    big = ex.words_for(32)
    assert big is not small and len(ex.retired) == 1
    assert ex.retired[0] is small and bool((small == 3).all())
    big.fill_(4)
    ex.epoch = dk.EPOCH_RESTART - 2
    ex.reserve(1)
    assert not small.any() and not big.any()
    ex = dk._Exchange(torch.device("cpu"))
    ex.words_for(8)
    ex.words_for(32)
    assert ex.retired is None


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


# -- int32 indices at the 10M path's shapes -------------------------------------

INT32_MAX = 2**31 - 1


def _k1_int_indices(n, k, halo, itemsize, sms=132):
    """The largest value of each int ``dia_spmv_kernel`` forms: the thread
    index t, its first row i0 = t / k * rows (formed before the kernel
    returns past n) and x's row j = i0 + r + offset.  The band's and x's
    offsets (d * npad, j * k + c) are 64-bit."""
    npad = -(-n // DIA_TILE) * DIA_TILE
    g = dk.spmv_geometry(n, k, npad, itemsize, sms)
    t = g.blocks * g.threads - 1
    i0 = t // k * g.rows
    return {"t": t, "i0": i0, "j": min(i0, n - 1) + g.rows - 1 + halo}


def _k2_int_indices(n, ndiag, halo, itemsize, sms=132):
    """The same for K2's kernels: a block's first row, x's row i +
    offset, the last block it waits for and, staged, its shared band
    index d * rows + li, its x buffer's rows and the rows it polls (r0 +
    j); the words' and the band's offsets are 64-bit."""
    g = dk.gs_geometry(n, ndiag, halo, itemsize, sms)
    out = {"r0": (g.blocks - 1) * g.rows, "i + offset": n - 1 + halo,
           "block + reach": g.blocks - 1 + g.reach}
    if g.staged:
        out.update({"d * rows + li": ndiag * g.rows,
                    "rows + 2 * halo": g.rows + 2 * halo,
                    "r0 + j": n + halo})
    return out


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_indices_fit_int32(name, itemsize):
    n, ndiag, halo = SHAPES[name]
    for k in (1, 3):
        assert max(_k1_int_indices(n, k, halo, itemsize).values()) <= \
            INT32_MAX
    got = _k2_int_indices(n, ndiag, halo, itemsize)
    assert max(got.values()) <= INT32_MAX, got


def test_int32_index_check_sees_an_overflow():
    """The same arithmetic past 2^31 rows does not fit."""
    assert _k1_int_indices(1 << 31, 1, 3163, 4)["j"] > INT32_MAX
    assert _k2_int_indices(1 << 31, 5, 3163, 4)["i + offset"] > INT32_MAX
