"""K6 (``ops/dist_kernels.py``) and the distributed V-cycle's solve
layout (``parallel/dist_setup.py``: ``_solve_slices``) on the CPU.

The layout holds every stored entry of each level's A, P and R once, in
stored order, packed to the front of its row, with each slice as wide as
its fullest row; K6's launch covers every row once, and its walk over a
slice (groups of four slots, the last group predicated), emulated in
torch, equals the plain version bit for bit.  The plain version, in every
mode, equals the products the V-cycle ran before as torch gathers over
the padded level arrays (``_spmv_shard_overlap``, kept here as the
reference) to float64 rounding: each row's difference within a few ulps
of the sum of its terms' magnitudes.  Reading each rank's margin-extended
block (the form of a multi-process ``RowMesh``) gives the same products
as reading the process's own rows, bit for bit.  The hierarchies are SA
(Jacobi and Chebyshev) and classical, float64, at 64^2 on an 8-rank
``StackedMesh`` and at 40^2 on a one-rank gloo ``RowMesh``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pyamg_tpu_torch.ops import dist_kernels as dk
from pyamg_tpu_torch.ops import launch
from pyamg_tpu_torch.parallel import dist_setup as pd
from pyamg_tpu_torch.parallel import partition as pt

torch.set_num_threads(1)

STENCIL = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
SETUPS = ("sa", "chebyshev", "classical")
MESHES = ("stacked8", "ring1")
EPS = torch.finfo(torch.float64).eps


@pytest.fixture(scope="module")
def hiers():
    """{(setup, mesh): (hierarchy, exchange)}, float64, at 64^2 on 8
    ranks and 40^2 on one (three levels or more each); the one-rank gloo
    group lives as long as the module's tests."""
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    out = {}
    for mname in MESHES:
        mesh = pd.StackedMesh(8, "cpu") if mname == "stacked8" else \
            pt.make_row_mesh(1, device="cpu")
        N = 64 if mname == "stacked8" else 40
        c, v, o, n = pd.dist_stencil_grid(STENCIL, (N, N), mesh,
                                          dtype=torch.float64)
        for setup in SETUPS:
            if setup == "classical":
                H = pd.distributed_classical_setup(c, v, o, n, mesh,
                                                   coarsen_until=64)
            else:
                H = pd.distributed_sa_setup(
                    c, v, o, n, mesh, coarsen_until=64,
                    smoother="chebyshev" if setup == "chebyshev" else
                    "jacobi")
            out[(setup, mname)] = (H, pd.exchange_of(mesh))
    yield out
    if made:
        dist.destroy_process_group()


def _vector(rng, rows, R, dtype=torch.float64):
    return torch.as_tensor(rng.standard_normal((R, rows))).to(dtype)


# -- the padded form the V-cycle ran before ----------------------------------

def _spmv_shard_overlap(vals, cols_g, valid, x, x_ext, row0, g_margin):
    """A x on each rank as an interior term plus a ghost term (the solve
    phase's product before K6)."""
    n = x.shape[1]
    loc = cols_g - row0.view(-1, 1, 1)
    is_local = valid & (loc >= 0) & (loc < n)
    gl = pd._flat_take(x, torch.clamp(loc, 0, n - 1))
    y_int = torch.sum(torch.where(is_local, vals * gl, 0), dim=-1)
    ghost = valid & ~is_local
    ge, _ = pd._gather_ext(x_ext, cols_g, row0 - g_margin, ghost)
    y_gh = torch.sum(torch.where(ghost, vals * ge, 0), dim=-1)
    return y_int + y_gh


def _blocks(ex, rows, *arrays):
    return [a.view((ex.R, rows) + tuple(a.shape[1:])) for a in arrays]


def _old_A(ex, L, v, vals=None):
    cols, okv, vv = _blocks(ex, L.n_loc, L.cols.long(), L.ok,
                            L.vals if vals is None else vals)
    return _spmv_shard_overlap(vv, cols, okv, v, ex.ext_rows(v, L.g),
                               ex.row0(L.n_loc), L.g)


def _old_R(ex, L, nc, r, vals=None):
    rc, rv, ro = _blocks(ex, nc, L.r_cols.long(),
                         L.r_vals if vals is None else vals, L.r_ok)
    return torch.sum(torch.where(ro, rv, 0) *
                     pd._flat_take(ex.ext_rows(r, L.gp), rc), dim=-1)


def _old_P(ex, L, Lc, xc, vals=None):
    gc = max(Lc.g, L.gcp)
    pc, pv, po = _blocks(ex, L.n_loc, L.p_cols.long(),
                         L.p_vals if vals is None else vals, L.p_ok)
    return pd._spmv_shard(pv, pc, po, ex.ext_rows(xc, gc),
                          ex.row0(Lc.n_loc) - gc)


# -- the layout ---------------------------------------------------------------

def _decode(layout):
    """Each row's slots [(column, value)] as the kernel walks them."""
    sptr = layout.sptr.tolist()
    cols, vals = layout.cols.tolist(), layout.vals.tolist()
    out = []
    for row in range(layout.rows):
        s, lane = divmod(row, dk.SLICE)
        width = (sptr[s + 1] - sptr[s]) // dk.SLICE
        at = [sptr[s] + dk.SLICE * k + lane for k in range(width)]
        out.append([(cols[j], vals[j]) for j in at])
    return out


def _stored(cols, vals, ok, R, rows, n_src, g, ext):
    """Each row's stored entries [(global row of the source, value)] in
    stored order, from the padded arrays."""
    c, v, o = cols.long().numpy(), vals.numpy(), ok.numpy()
    out = []
    for i in range(R * rows):
        r = i // rows
        glob = c[i] + (r * n_src - g if ext else 0)
        out.append([(int(a), float(b)) for a, b in zip(glob[o[i]],
                                                       v[i][o[i]])])
    return out


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("setup", SETUPS)
def test_layout_holds_every_stored_entry_once(hiers, setup, mname):
    """Every stored entry of every A, P and R once, in stored order at the
    front of its row; the rest of the row's slots 0 with a column of the
    row; each slice as wide as its fullest row; identity rows of width 1
    and R's empty rows of width 0 where the levels have them."""
    H, ex = hiers[(setup, mname)]
    levs = pd._solve_slices(ex, H.levels)
    assert len(levs) == len(H.levels) - 1 >= 2
    R = ex.R
    seen_identity = seen_empty = False
    for i, (L, S) in enumerate(zip(H.levels, levs)):
        n, nc = L.n_loc, H.levels[i + 1].n_loc
        ops = [(S.A, _stored(L.cols, L.vals, L.ok, R, n, n, L.g, False)),
               (S.P, _stored(L.p_cols, L.p_vals, L.p_ok, R, n, nc, 0,
                             False)),
               (S.R, _stored(L.r_cols, L.r_vals, L.r_ok, R, nc, n, L.gp,
                             True))]
        for name, (layout, want) in zip("APR", ops):
            assert layout.rows == len(want)
            got = _decode(layout)
            counts = [len(w) for w in want]
            for row, (g, w) in enumerate(zip(got, want)):
                assert g[:len(w)] == w, (i, name, row)
                fill = w[0][0] if w else 0
                assert all(p == (fill, 0.0) for p in g[len(w):]), \
                    (i, name, row)
            widths = [max(counts[s:s + dk.SLICE])
                      for s in range(0, len(counts), dk.SLICE)]
            assert (layout.sptr[1:] - layout.sptr[:-1]).tolist() == \
                [dk.SLICE * w for w in widths]
            assert layout.width_sum == sum(widths)
            assert layout.max_width == max(widths)
            assert layout.cols.numel() == dk.SLICE * sum(widths)
            assert layout.src_len == ex.ndev * (nc if name == "P" else n)
            assert 0 <= int(layout.cols.min()) and \
                int(layout.cols.max()) < layout.src_len
            if i > 0 and name == "A":
                seen_identity |= any(w == [(row, 1.0)] for row, w in
                                     enumerate(want))
            if name == "R":
                seen_empty |= 0 in counts
    assert seen_identity and seen_empty


# -- the launch and the kernel's walk -----------------------------------------

SMS = 132
GROUP = 4           # slots a thread loads before it adds (kGroup)


@pytest.mark.parametrize("rows", [1, 5, 31, 32, 33, 1000, 1952, 7810,
                                  31_240, SMS * 32 * 8 + 7, 124_962,
                                  499_849, 1_999_396])
def test_geometry_covers_every_row_once(rows):
    g = dk.geometry(rows, SMS)
    # the launch shapes the CUDA entry point accepts
    assert 32 <= g.threads <= dk.MAX_THREADS and g.threads % 32 == 0
    assert (g.blocks - 1) * g.threads < rows <= g.blocks * g.threads
    if rows >= 32 * SMS * 2:            # spread over every SM
        assert g.blocks >= SMS
    t = np.arange(g.blocks * g.threads)
    block, tid = t // g.threads, t % g.threads
    row = block * g.threads + tid
    live = row < rows
    assert np.array_equal(np.bincount(row[live], minlength=rows),
                          np.ones(rows, np.int64))
    # a warp's lanes are the 32 rows of one slice
    assert np.array_equal(row[live] // 32, (block * g.threads + tid -
                                            tid % 32)[live] // 32)
    assert np.array_equal(row[live] % 32, (tid % 32)[live])


def _kernel_walk(layout, src, mode, x, b, w):
    """K6's walk as ``csrc/dist_kernels.cu`` does it, for every row at
    once: from its slice's first slot plus its lane, groups of ``GROUP``
    slots (columns and values, then the gathers, then the adds in slot
    order), the last group cut at the slice's width; then the mode's
    update (none of it for jacobi0, the sweep from zero)."""
    if mode == "jacobi0":
        return 0.0 + w * b
    rows = torch.arange(layout.rows)
    s = rows >> 5
    lo = layout.sptr[s]
    width = (layout.sptr[s + 1] - lo) >> 5
    at = lo + (rows & 31)
    acc = torch.zeros(layout.rows, dtype=layout.vals.dtype)
    for k in range(0, layout.max_width, GROUP):
        live = [(k + u) < width for u in range(GROUP)]
        ci = [torch.where(live[u], layout.cols[torch.where(
            live[u], at + 32 * (k + u), 0)].long(), 0)
            for u in range(GROUP)]
        vi = [layout.vals[torch.where(live[u], at + 32 * (k + u), 0)]
              for u in range(GROUP)]
        xi = [src[ci[u]] for u in range(GROUP)]
        for u in range(GROUP):
            acc = torch.where(live[u], acc + vi[u] * xi[u], acc)
    if mode == "residual":
        return b - acc
    if mode == "jacobi":
        return x + w * (b - acc)
    if mode == "correct":
        return x + acc
    return acc


@pytest.mark.parametrize("nonfinite", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", sorted(dk.MODES))
def test_kernel_walk_equals_the_plain_version(hiers, mode, dtype,
                                              nonfinite):
    """Every product of the 8-rank SA hierarchy, the kernel's walk against
    the plain version bit for bit (inf and NaN at the same places)."""
    H, ex = hiers[("sa", "stacked8")]
    rng = np.random.default_rng(1)
    for S in pd._solve_slices(ex, H.levels):
        for op in (S.A, S.P, S.R):
            L = dataclasses.replace(op, vals=op.vals.to(dtype))
            src = torch.as_tensor(rng.standard_normal(L.src_len)).to(dtype)
            if nonfinite:
                src[::97] = torch.inf
                src[5::101] = torch.nan
            x, b, w = (torch.as_tensor(rng.standard_normal(L.rows)).to(dtype)
                       for _ in range(3))
            kw = {k: v for k, v in (("x", x), ("b", b), ("w", w))
                  if k in dk._NEEDS[mode]}
            if mode == "jacobi0":
                src = None
            want = dk.dist_slice_apply_plain(L, src, mode, **kw)
            got = _kernel_walk(L, src, mode, x, b, w)
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)


# -- the plain version against the padded torch form --------------------------

def _near(got, want, scale, terms):
    """|got - want| within 4 * terms ulps of each row's ``scale`` (the sum
    of the magnitudes of what it adds)."""
    bound = 4 * terms * EPS * scale
    assert bool((torch.abs(got - want) <= bound).all()), \
        float(torch.abs(got - want).max())


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("setup", SETUPS)
def test_plain_equals_the_padded_torch_form(hiers, setup, mname):
    """Each level's products in every mode, and one whole V-cycle, against
    the torch form over the padded arrays: to float64 rounding."""
    H, ex = hiers[(setup, mname)]
    levs = pd._solve_slices(ex, H.levels)
    rng = np.random.default_rng(2)
    R = ex.R
    for i, (L, S) in enumerate(zip(H.levels, levs)):
        n, Lc = L.n_loc, H.levels[i + 1]
        x, b, v = (_vector(rng, n, R) for _ in range(3))
        xc = _vector(rng, Lc.n_loc, R)
        W = L.cols.shape[1]
        Ax = _old_A(ex, L, x)
        mag = _old_A(ex, L, x.abs(), L.vals.abs())
        _near(S.apply(ex, x), Ax, mag, W)
        _near(S.residual(ex, x, b), b - Ax, mag + b.abs(), W + 1)
        w = (L.omega * L.Dinv).view(R, n)
        _near(S.jacobi(ex, x, b), x + w * (b - Ax),
              x.abs() + w.abs() * (mag + b.abs()), W + 3)
        # the sweep from zero reads no product: exactly the one from zeros
        z = torch.zeros_like(x)
        assert torch.equal(S.jacobi(ex, None, b), z + w * (b - _old_A(ex, L,
                                                                     z)))
        e = _old_P(ex, L, Lc, xc)
        emag = _old_P(ex, L, Lc, xc.abs(), L.p_vals.abs())
        _near(S.correct(ex, x, xc), x + e, x.abs() + emag,
              L.p_cols.shape[1] + 1)
        nc = Lc.n_loc
        _near(S.restrict(ex, v), _old_R(ex, L, nc, v),
              _old_R(ex, L, nc, v.abs(), L.r_vals.abs()),
              L.r_cols.shape[1])
    # the whole cycle: the same to a few ulps of the iterate's size
    r = _vector(rng, H.levels[0].n_loc, R)
    got = H._vcycle_shard(ex, levs, torch.zeros_like(r), r)
    want = _old_vcycle(H, ex, torch.zeros_like(r), r)
    assert float((got - want).abs().max()) <= \
        1e-12 * float(want.abs().max())


def _old_vcycle(H, ex, x, b, nu=2):
    """The V-cycle as it ran before K6 (``_vcycle_shard`` over the padded
    arrays)."""
    levels = H.levels

    def smooth(L, x, b):
        def Amv(v):
            return _old_A(ex, L, v)
        if L.cheb is not None:
            co = L.cheb
            r = b - Amv(x)
            h = co[0] * r
            for i in range(1, co.shape[0]):
                h = co[i] * r + Amv(h)
            return x + h
        for _ in range(nu):
            x = x + L.omega * L.Dinv.view(ex.R, -1) * (b - Amv(x))
        return x

    def cycle(l, x, b):
        L = levels[l]
        if l == len(levels) - 1:
            xg = H.coarse_dense @ ex.gather_rows(b)
            return xg.view(ex.ndev, -1)[ex.ranks]
        x = smooth(L, x, b)
        bc = _old_R(ex, L, levels[l + 1].n_loc, b - _old_A(ex, L, x))
        xc = cycle(l + 1, torch.zeros_like(bc), bc)
        return smooth(L, x + _old_P(ex, L, levels[l + 1], xc), b)

    return cycle(0, x, b)


@pytest.mark.parametrize("setup", SETUPS)
def test_extended_blocks_equal_direct_reads(hiers, setup):
    """The layout over each rank's margin-extended block (what a rank of
    a multi-process ``RowMesh`` reads) against the one over the process's
    own rows: every product of every level in every mode, bit for bit."""
    H, ex = hiers[(setup, "stacked8")]
    ext = copy.copy(ex)
    ext.direct = False
    rng = np.random.default_rng(3)
    R = ex.R
    for i, (S, T) in enumerate(zip(pd._solve_slices(ex, H.levels),
                                   pd._solve_slices(ext, H.levels))):
        n, nc = H.levels[i].n_loc, H.levels[i + 1].n_loc
        x, b = _vector(rng, n, R), _vector(rng, n, R)
        xc = _vector(rng, nc, R)
        assert T.A.src_len == R * (n + 2 * S.g)
        for fn, args in (("apply", (x,)), ("residual", (x, b)),
                         ("jacobi", (x, b)), ("correct", (x, xc)),
                         ("restrict", (x,))):
            assert torch.equal(getattr(S, fn)(ex, *args),
                               getattr(T, fn)(ext, *args)), (i, fn)


# -- the wrapper --------------------------------------------------------------

def _small_layout(dtype=torch.float64):
    idx = torch.tensor([[0, 1, 0], [1, 2, 0], [2, 0, 0]])
    vals = torch.tensor([[2.0, -1, 0], [2, -1, 0], [2, 0, 0]], dtype=dtype)
    keep = torch.tensor([[True, True, False], [True, True, False],
                         [True, False, False]])
    return dk.slice_layouts([(idx, vals, keep, 3)], torch.Tensor.tolist)[0]


@pytest.mark.parametrize("fault", ["mode", "dtype", "src_shape", "missing",
                                   "extra", "strided", "int_layout",
                                   "zero_with_src"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(fault):
    L = _small_layout()
    src = v = torch.ones(3, dtype=torch.float64)
    args, kw = (L, src), {}
    if fault == "mode":
        kw = {"mode": "transpose"}
    elif fault == "dtype":
        args = (L, src.float())
    elif fault == "src_shape":
        args = (L, torch.ones(4, dtype=torch.float64))
    elif fault == "missing":
        kw = {"mode": "jacobi", "x": v, "b": v}
    elif fault == "extra":
        kw = {"mode": "apply", "b": v}
    elif fault == "strided":
        kw = {"mode": "residual",
              "b": torch.ones(6, dtype=torch.float64)[::2]}
    elif fault == "zero_with_src":
        kw = {"mode": "jacobi0", "b": v, "w": v}
    else:
        args = (dataclasses.replace(L, vals=L.vals.long()), src)
    with pytest.raises((TypeError, ValueError)):
        dk.dist_slice_apply(*args, **kw)


def test_cpu_tensors_run_the_plain_version_and_count_nothing():
    L = _small_layout()
    src = torch.tensor([1.0, 2.0, 5.0], dtype=torch.float64)
    launch.reset_launch_counts()
    y = dk.dist_slice_apply(L, src, "residual",
                            b=torch.zeros(3, dtype=torch.float64))
    assert y.tolist() == [0.0, 1.0, -10.0]
    assert dk.dist_slice_apply.launches == 0 and not dk.dist_slice_apply.by_op
    assert L.width_sum == 2 and L.max_width == 2 and L.rows == 3


@pytest.mark.parametrize("mname", MESHES)
def test_the_solve_reads_no_padded_level_array(hiers, mname, monkeypatch):
    """CG on a hierarchy whose layout is built, with the padded form's
    gathers patched to raise: the solve phase runs on the layouts alone
    and converges."""
    H, ex = hiers[("sa", mname)]
    b = np.random.default_rng(4).standard_normal(H.levels[0].n)
    H._slices(ex)

    def refuse(*a, **k):
        raise AssertionError("a padded gather in the solve phase")
    for name in ("_spmv_shard", "_flat_take", "_gather_ext"):
        monkeypatch.setattr(pd, name, refuse)
    x, relres, it = H.solve_cg(b, tol=1e-8, maxiter=40)
    assert relres < 1e-8 and 0 < it < 40


def test_a_recorded_graph_counts_its_launches_in_one_tally(monkeypatch):
    """``_graph.tally``: at once outside a recording (nothing while a
    device loop warms up), else one tally a graph and kind whose counts
    the replay hands over in one call."""
    from pyamg_tpu_torch import _graph
    seen = []
    _graph.tally(seen.append, "a")
    assert seen == [{"a": 1}]
    monkeypatch.setattr(_graph, "_quiet", True)
    _graph.tally(seen.append, "a")
    assert seen == [{"a": 1}]
    monkeypatch.setattr(_graph, "_quiet", False)
    hooks = [lambda: None]
    monkeypatch.setattr(_graph, "_recording", hooks)
    for key in ("a", "b", "a", "a"):
        _graph.tally(seen.append, key)
    other = []
    _graph.tally(other.append, "a")
    assert len(hooks) == 3 and seen == [{"a": 1}] and not other
    monkeypatch.setattr(_graph, "_recording", None)
    _graph._run_hooks(hooks)
    assert seen == [{"a": 1}, {"a": 3, "b": 1}] and other == [{"a": 1}]
