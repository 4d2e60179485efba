"""K7 (``ops/bell_kernels.py``) on the CPU: its layout, its plain version
against the torch formula of the block products and block smoothers it
replaced, its checks and its counters.

The layout holds every block of each row once, in stored order, in the
slot the kernel reads (``(slice * width + k) * 32 + lane``, each block
component by component), a padding slot a zero block and its row's first
stored column, and, grouped by a coloring, each color's rows in slices of
their own; a walk of the layout as the kernel walks it, emulated in
torch, gives the product.  The plain version equals the torch formula it
replaced (the gather of x's blocks and one einsum for a product; a full
product, the batched product with the inverted diagonal blocks and a
masked update for a sweep) to float rounding, and a color pass leaves the
other colors' rows of x as they were, bit for bit.  A placed hierarchy
builds each BELL's one layout at set-up (a level's operator grouped by
its block Gauss-Seidel's coloring), and its cycles read nothing on the
host; a BELL placed alone gets its layout at its first product, with no
host read.  The layout build raises on a coloring that is not proper on
the block graph or has colors past its count.  On random BELLs of 1 x 1,
2 x 2, 3 x 3, 2 x 3 and 3 x 2 blocks (and blocks wider than K7 sums in
registers), with padding slots past every row's stored blocks, float32
and float64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu_torch import _graph, _trace
from pyamg_tpu_torch.ops import bell_kernels as bk
from pyamg_tpu_torch.ops import launch
from pyamg_tpu_torch.ops.spmv import bspmv, residual
from pyamg_tpu_torch.relaxation import relaxation as rx
from pyamg_tpu_torch.sparse.matrix import BELL, bell_from_scipy

from test_torch_relaxation import forbid_host_reads

torch.set_num_threads(1)

BLOCKS = [(1, 1), (2, 2), (3, 3), (2, 3), (3, 2)]
SQUARE = [b for b in BLOCKS if b[0] == b[1]]
DTYPES = [torch.float32, torch.float64]


def _bell(blocksize, dtype, nb=70, mb=None, seed=0, pad=2):
    """A random host BELL of ``nb`` x ``mb`` blocks (square: a symmetric
    pattern with every diagonal block), ``pad`` padding slots past its
    fullest row."""
    br, bc = blocksize
    mb = nb if mb is None else mb
    rng = np.random.default_rng(seed)
    P = sp.random(nb, mb, density=4 / mb, random_state=seed, format="csr")
    if nb == mb:
        P = P + P.T + sp.eye(nb)
    P = P.tocsr()
    P.sort_indices()
    data = rng.standard_normal((P.nnz, br, bc))
    B = bell_from_scipy(sp.bsr_matrix((data, P.indices, P.indptr),
                                      shape=(nb * br, mb * bc)))
    W = B.width + pad
    cols = np.zeros((nb, W), np.int32)
    vals = np.zeros((nb, W, br, bc), np.float64)
    cols[:, :B.width], vals[:, :B.width] = B.cols, B.vals
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    return BELL(cols, vals.astype(np_dtype), B.row_nnz, B.shape, B.blocksize)


def _vec(n, dtype, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                           dtype=dtype)


def _colored(A):
    """(placed A, colors, rows of each color) of a square host BELL's block
    coloring."""
    colors, nc = rx.make_coloring(rx.block_pattern(A))
    sizes = tuple(int(n) for n in np.bincount(colors, minlength=nc))
    return A.to("cpu"), torch.as_tensor(colors), sizes


def _formula(A, x):
    """The torch formula of a block product that K7 replaced."""
    br, bc = A.blocksize
    return torch.einsum("nwij,nwj->ni", A.vals, x.reshape(
        A.n_block_cols, bc)[A.cols]).reshape(-1)


def _close(got, want, dtype, scale):
    tol = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]
    assert float((got - want).abs().max()) <= tol * scale


def _walk(L, x):
    """The product as K7 walks the layout: every live layout row's slots
    in order (float64 sums), into each row's outputs."""
    br, bc = L.blocksize
    BB = br * bc
    lr = torch.arange(L.slices * 32)
    row = lr if L.rowmap is None else L.rowmap.long()
    live = (row >= 0) & (row < L.nb)
    lr, row = lr[live], row[live]
    base = ((lr // 32)[:, None] * L.width + torch.arange(L.width)) * 32
    cols = L.cols[base + (lr % 32)[:, None]].long()          # (n, W)
    comp = 32 * torch.arange(BB)
    blocks = L.vals[(base * BB)[:, :, None] + comp + (lr % 32)[:, None, None]]
    xb = x.double().reshape(L.nbc, bc)[cols]                 # (n, W, bc)
    prod = torch.einsum("nwij,nwj->ni",
                        blocks.double().reshape(-1, L.width, br, bc), xb)
    y = torch.zeros(L.nb, br, dtype=torch.float64)
    y[row] = prod
    return y.reshape(-1), row, cols, blocks


# -- the layout ----------------------------------------------------------------

@pytest.mark.parametrize("blocksize,grouped", [(b, False) for b in BLOCKS]
                         + [(b, True) for b in SQUARE])
def test_layout_holds_every_block_where_the_kernel_reads_it(blocksize,
                                                            grouped):
    square = blocksize[0] == blocksize[1]
    H = _bell(blocksize, torch.float64, mb=None if square else 50)
    A = H.to("cpu")
    if grouped:
        A, colors, sizes = _colored(H)
        L = bk.build_layout(A, colors, len(sizes))
        assert [n for _, n in L.groups] == list(sizes)
        assert all(first % 32 == 0 for first, _ in L.groups)
        assert L.colors is colors
        for g, (first, n) in enumerate(L.groups):
            assert bool((colors[L.rows(g)] == g).all())
            assert torch.equal(L.rowmap[first:first + n].long(), L.rows(g))
            assert bool((L.rows(g)[1:] > L.rows(g)[:-1]).all())
    else:
        L = bk.build_layout(A)
        assert L.rowmap is None and L.groups == ((0, A.n_block_rows),)
    x = _vec(A.shape[1], torch.float64, 1)
    y, row, cols, blocks = _walk(L, x)
    assert sorted(row.tolist()) == list(range(A.n_block_rows))
    br, bc = blocksize
    cnt = A.row_nnz.long()[row]
    k = torch.arange(A.width)[None, :]
    stored = k < cnt[:, None]
    assert torch.equal(cols[stored], A.cols[row][stored])
    first = torch.where(cnt > 0, A.cols[row, 0], row if square else 0)
    assert torch.equal(cols[~stored], first[:, None].expand_as(cols)[
        ~stored])
    assert torch.equal(blocks.reshape(-1, A.width, br, bc), A.vals[row])
    _close(y, _formula(A, x), torch.float64, float(y.abs().max()) + 1)


def test_a_placed_hierarchy_keeps_one_layout_a_bell(monkeypatch):
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import linear_elasticity
    A, B = linear_elasticity((12, 12))
    ml = smoothed_aggregation_solver(
        A, B=B, max_coarse=20,
        presmoother=("block_gauss_seidel", {"sweep": "symmetric"}),
        postsmoother=("block_gauss_seidel", {"sweep": "symmetric"}))
    ml.to_device("cpu")
    kept = []
    for lvl in ml.levels[:-1]:
        L = lvl.A.__dict__["_k7_layout"]
        pre, post = lvl.pre[2], lvl.post[2]
        # one layout a level, grouped by the coloring both smoothers share
        assert L.colors is pre["colors"] is post["colors"]
        assert len(L.groups) == lvl.pre[1]["ncolors"]
        for op in (lvl.P, lvl.R):
            assert op.__dict__["_k7_layout"].rowmap is None
        kept.append(L)
    b = _vec(A.shape[0], torch.float64, 3)
    _trace.reset()
    forbid_host_reads(monkeypatch)
    cyc = ml._make_cycle("V")
    cyc(torch.zeros_like(b), b)
    monkeypatch.undo()
    c = _trace.snapshot()["counters"]
    assert "bell.layout" not in _trace.snapshot()["totals"]
    assert c["bell.gs_passes"] == sum(4 * lvl.pre[1]["ncolors"]
                                      for lvl in ml.levels[:-1])
    assert [lvl.A.__dict__["_k7_layout"] for lvl in ml.levels[:-1]] == kept


def test_a_bell_placed_alone_gets_its_layout_at_its_first_product(
        monkeypatch):
    A = _bell((2, 2), torch.float32).to("cpu")
    x = _vec(A.shape[1], torch.float32, 1)
    forbid_host_reads(monkeypatch)
    y = bspmv(A, x)
    monkeypatch.undo()
    L = A.__dict__["_k7_layout"]
    assert L.rowmap is None and bk.layout_of(A) is L
    _close(y, _formula(A, x), torch.float32, float(y.abs().max()) + 1)


def test_layout_raises_on_a_coloring_that_is_not_proper():
    A, colors, sizes = _colored(_bell((2, 2), torch.float64))
    # give a row the color of one of its stored neighbours
    i = int(torch.nonzero(A.row_nnz > 1)[0])
    j = next(int(c) for c in A.cols[i, :int(A.row_nnz[i])] if c != i)
    bad = colors.clone()
    bad[i] = colors[j]
    with pytest.raises(ValueError, match="not proper"):
        bk.build_layout(A, bad, len(sizes))


def test_layout_raises_on_colors_past_their_count():
    A, colors, sizes = _colored(_bell((2, 2), torch.float64))
    with pytest.raises(ValueError, match="integers in"):
        bk.build_layout(A, colors, len(sizes) - 1)
    with pytest.raises(ValueError, match="integers in"):
        bk.build_layout(A, colors - 1, len(sizes))


# -- the plain version against the formula it replaced ------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocksize", BLOCKS)
def test_products_equal_the_einsum_they_replaced(blocksize, dtype):
    square = blocksize[0] == blocksize[1]
    A = _bell(blocksize, dtype, mb=None if square else 40, seed=3).to("cpu")
    x = _vec(A.shape[1], dtype, 4)
    b = _vec(A.shape[0], dtype, 5)
    want = _formula(A, x)
    scale = float(want.abs().max()) + 1
    _close(bspmv(A, x), want, dtype, scale)
    _close(residual(A, x, b), b - want, dtype, scale)
    L = bk.build_layout(A)
    _close(bk.bell_apply_plain(L, x), _walk(L, x)[0].to(dtype), dtype, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocksize", SQUARE)
def test_color_passes_equal_the_masked_update_they_replaced(blocksize,
                                                            dtype):
    A, colors, sizes = _colored(_bell(blocksize, dtype, seed=6))
    Dinv = rx.block_dinv(A)
    L = bk.build_layout(A, colors, len(sizes))
    x = _vec(A.shape[0], dtype, 7)
    b = _vec(A.shape[0], dtype, 8)
    br = blocksize[0]
    for c in range(len(sizes)):
        for omega in (1.0, 0.8):
            want = x + omega * rx._block_update(A, x, b, Dinv, colors == c)
            got = bk.bell_apply(L, x.clone(), "gs_color", b=b, dinv=Dinv,
                                omega=omega, group=c)
            off = (colors != c).repeat_interleave(br)
            assert torch.equal(got[off], x[off])
            _close(got, want, dtype, float(want.abs().max()) + 1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("blocksize", SQUARE)
def test_jacobi_sweeps_equal_the_formula_they_replaced(blocksize, dtype):
    A = _bell(blocksize, dtype, seed=9).to("cpu")
    Dinv = rx.block_dinv(A)
    x = _vec(A.shape[0], dtype, 10)
    b = _vec(A.shape[0], dtype, 11)
    mask = torch.as_tensor(np.arange(A.n_block_rows) % 3 == 1)
    L = bk.build_layout(A)
    for m in (None, mask):
        want = x + 0.7 * rx._block_update(A, x, b, Dinv, m)
        got = bk.bell_apply(L, x, "jacobi", b=b, dinv=Dinv, omega=0.7,
                            mask=m)
        _close(got, want, dtype, float(want.abs().max()) + 1)
        if m is not None:
            off = (~m).repeat_interleave(blocksize[0])
            assert torch.equal(got[off], x[off])


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_block_gauss_seidel_runs_its_passes_on_a_copy(sweep):
    H = _bell((2, 2), torch.float64, seed=12)
    A, colors, sizes = _colored(H)
    Dinv = rx.block_dinv(A)
    x = _vec(A.shape[0], torch.float64, 13)
    b = _vec(A.shape[0], torch.float64, 14)
    x0 = x.clone()
    bk.attach(A, colors, len(sizes))
    kw = dict(iterations=2, sweep=sweep, Dinv=Dinv, ncolors=len(sizes))
    _trace.reset()
    got = rx.block_gauss_seidel(A, x, b, colors=colors, **kw)
    assert torch.equal(x, x0)
    launches = _trace.snapshot()["counters"]["bell_kernels.launches"]
    assert launches == len(sizes) * (4 if sweep == "symmetric" else 2)
    # the same passes as full products and masked updates (host arrays)
    want = rx.block_gauss_seidel(H, x0.numpy(), b.numpy(), iterations=2,
                                 sweep=sweep, Dinv=Dinv.numpy(),
                                 colors=colors.numpy(), ncolors=len(sizes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # a coloring the layout does not follow: full products and masks
    _trace.reset()
    other = rx.block_gauss_seidel(A, x, b, colors=colors.clone(), **kw)
    c = _trace.snapshot()["counters"]
    assert c["bell.products"] == c["bell.gs_passes"] == launches
    np.testing.assert_allclose(other.numpy(), want, rtol=1e-12, atol=1e-12)


# -- checks and counters -----------------------------------------------------

def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    A, colors, sizes = _colored(_bell((2, 2), torch.float32))
    L = bk.build_layout(A, colors, len(sizes))
    x = _vec(A.shape[0], torch.float32, 1)
    D = rx.block_dinv(A)
    with pytest.raises(ValueError):
        bk.bell_apply(L, x, "sideways")
    with pytest.raises(ValueError):
        bk.bell_apply(L, x, "gs_color", b=x, dinv=D)          # no color
    with pytest.raises(ValueError):
        bk.bell_apply(L, x, "apply", group=0)
    with pytest.raises(ValueError):
        bk.bell_apply(L, x, "gs_color", b=x, dinv=D, group=len(sizes))
    with pytest.raises(TypeError):
        bk.bell_apply(L, x.double())
    with pytest.raises(ValueError):
        bk.bell_apply(L, x[:-1])
    with pytest.raises(TypeError):
        bk.bell_apply(L, x, "residual")                        # no b
    with pytest.raises(TypeError):
        bk.bell_apply(L, x, "jacobi", b=x, dinv=D,
                      omega=torch.tensor(1.0))
    R = bk.build_layout(_bell((2, 3), torch.float32, mb=30).to("cpu"))
    with pytest.raises(ValueError):
        bk.bell_apply(R, _vec(90, torch.float32, 2), "jacobi",
                      b=_vec(140, torch.float32, 3), dinv=D)


def test_every_launch_is_counted_by_mode_and_shape():
    A, colors, sizes = _colored(_bell((2, 2), torch.float32))
    L = bk.attach(A, colors, len(sizes))
    x = _vec(A.shape[0], torch.float32, 1)
    D = rx.block_dinv(A)
    _trace.reset()
    launch.reset_launch_counts()
    bspmv(A, x)
    residual(A, x, x)
    for c in range(len(sizes)):
        bk.bell_apply(L, x.clone(), "gs_color", b=x, dinv=D, group=c)
    bk.bell_apply(L, x, "jacobi", b=x, dinv=D,
                  mask=torch.ones(A.n_block_rows, dtype=torch.bool))
    bspmv(A, torch.stack([x, x], 1))          # several vectors: no K7
    c = _trace.snapshot()["counters"]
    nb = A.n_block_rows
    assert c["bell_kernels.launches"] == bk.bell_apply.launches == \
        3 + len(sizes)
    assert c["bell.gs_passes"] == len(sizes)
    assert c["bell.products"] == 3             # apply, residual, einsum
    by_op = bk.bell_apply.by_op
    shape = (2, 2, A.width, 4)
    assert by_op[("apply", nb, nb, nb, *shape)] == 1
    assert by_op[("residual", nb, nb, nb, *shape)] == 1
    for n in set(sizes):
        assert by_op[("gs_color", nb, nb, n, *shape)] == sizes.count(n)
    assert by_op[("jacobi_indexed", nb, nb, nb, *shape)] == 1
    assert sum(by_op.values()) == bk.bell_apply.launches
    assert c[f"bell.products[nb={nb},nbc={nb},bs=2x2,w={A.width},"
             f"item=4]"] == 3


def test_a_recorded_launch_counts_on_every_replay():
    A = _bell((3, 3), torch.float32).to("cpu")
    x = _vec(A.shape[0], torch.float32, 1)
    bk.attach(A)
    _trace.reset()
    hooks = []
    _graph._recording = hooks
    try:
        bspmv(A, x)
        bspmv(A, x)
    finally:
        _graph._recording = None
    assert "bell_kernels.launches" not in _trace.snapshot()["counters"]
    # one tally of the launches and one of the block products
    assert len(hooks) == 2
    for _ in range(3):
        for tally in hooks:
            tally()
    c = _trace.snapshot()["counters"]
    assert c["bell_kernels.launches"] == c["bell.products"] == 6


def test_geometry_covers_the_rows():
    for rows in (1, 31, 32, 6241, 125316, 501264):
        g = bk.geometry(rows)
        assert g.threads % 32 == 0 and 32 <= g.threads <= bk.MAX_THREADS
        assert g.blocks * g.threads >= rows > (g.blocks - 1) * g.threads


@pytest.mark.parametrize("blocksize", [(9, 9), (4, 10), (10, 4)])
def test_blocks_wider_than_the_registers_take_every_mode(blocksize):
    """K7 takes any block side (past ``MAX_SIDE`` its runtime-sided
    kernel sums the rows in turns); the plain version and the checks
    take them alike."""
    square = blocksize[0] == blocksize[1]
    A = _bell(blocksize, torch.float64, nb=40, mb=None if square else 30,
              seed=15).to("cpu")
    x = _vec(A.shape[1], torch.float64, 16)
    b = _vec(A.shape[0], torch.float64, 17)
    want = _formula(A, x)
    scale = float(want.abs().max()) + 1
    _close(bspmv(A, x), want, torch.float64, scale)
    _close(residual(A, x, b), b - want, torch.float64, scale)
    if square:
        Dinv = torch.as_tensor(np.random.default_rng(18).standard_normal(
            (A.n_block_rows,) + blocksize))
        got = rx.block_jacobi(A, x, b, Dinv=Dinv, omega=0.7)
        want = x + 0.7 * rx._block_update(A, x, b, Dinv, None)
        _close(got, want, torch.float64, float(want.abs().max()) + 1)
