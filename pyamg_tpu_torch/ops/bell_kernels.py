"""CUDA kernel K7 (the block (BELL) product, with the residual or a block
smoother's update fused after it), its plain PyTorch version, its layout,
its launch geometry and its launch counters.

No JAX counterpart file: the JAX package's ``bspmv`` is a ``jnp.einsum``
(``pyamg_tpu/ops/spmv.py:64-81``) and its block Gauss-Seidel color pass
a full product and a masked update, which XLA fuses.  Run as torch ops on
the card, the einsum was cuBLAS's batched gemv over a permuted copy of
the blocks, and each color pass computed every block row to keep one
color's.

K7 ``bell_apply`` reads a ``BellLayout`` of a BELL: its block rows in
groups (all of them in order, or one group a color of a block
Gauss-Seidel coloring), each group in whole slices of 32 layout rows
(one warp a slice, one thread a block row), every slice as wide as the
BELL, slot k of the 32 rows contiguous (int32 block columns, and each
block component by component).  ``attach`` builds it once, at set-up,
and keeps it on the BELL: ``MultilevelSolver.to_device`` for every BELL
of a placed hierarchy, a level's operator grouped by the coloring of its
block Gauss-Seidel (one layout serves the level's products and its
passes); a BELL placed outside a hierarchy gets the layout of its rows
in order at its first product (``layout_of``).  A product reads the
layout and the BELL's own arrays stay beside it (the plain version, the
several-vector einsum and the set-up read them).

One launch computes, by ``mode``, on every block row or on one color's:
``apply`` (``A x``), ``residual`` (``b - A x``), ``gs_color`` (``x_i +=
omega Dinv_i (b_i - (A x)_i)`` for the rows of one color, in place:
exact because the coloring is proper on the block graph, which the layout
build asserts) and ``jacobi`` (the same update into a new vector, on
every row, or on the rows of a mask with the others copied).
``csrc/bell_kernels.cu`` says how.

The plain version is the torch formula the solve ran before (x's blocks
gathered by block column and one einsum with the blocks; a sweep's
batched product with the inverted diagonal blocks), on a color's rows
alone for a color pass: on the CPU it is what the solve runs, and on the
card ``chip_smoke.py`` compares the kernel with it (to float rounding:
the einsum's order of additions is the library's).  The wrapper given
CUDA tensors launches the kernel or raises; given CPU tensors it runs the
plain version.

Counting, through ``ops/launch.py`` (so a launch recorded in a CUDA
graph counts on every run of it), on either device: ``launches`` and
``by_op`` on the wrapper, keyed by ``(mode, nb, nbc, rows, br, bc, width,
itemsize)`` (``rows``: the block rows the launch computed; a masked
Jacobi sweep is mode ``jacobi_indexed``, its rows all of them), and in
the store the counter ``bell_kernels.launches``; a product over every
block row (apply, residual, jacobi) is also a full block product,
``bell.products`` and ``bell.products[nb=..,nbc=..,bs=BRxBC,w=..,
item=..]`` (``count_bell_products``), and a color pass is
``bell.gs_passes`` (``count_gs_passes``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import _trace
from . import launch
from .launch import SM_COUNT, check_vector, ptr

FLOATS = (torch.float32, torch.float64)
SLICE = 32                  # layout rows a slice: one warp
MAX_THREADS = 256           # threads a block, at most (kMaxThreads)
MAX_SIDE = 8                # block rows summed in registers (kMaxSide)
MODES = {"apply": 0, "residual": 1, "gs_color": 2, "jacobi": 2}


@dataclasses.dataclass(frozen=True)
class BellLayout:
    """A BELL's block rows as groups of whole slices of 32 layout rows,
    every slice as wide as the BELL (``width`` slots).

    ``cols`` (int32) and ``vals`` hold ``32 * width`` slots a slice: slot
    k of lane l of slice s at ``(s * width + k) * 32 + l``, and its block
    component e at ``vals[(s * width + k) * 32 * br * bc + 32 e + l]``.
    ``rowmap`` (int32, ``32 * slices``) is the block row of each layout
    row, -1 for a lane past its group; None for the identity (one group,
    every row in order).  ``groups``: (first layout row, block rows) of
    each group; ``a_cols``, ``a_vals``: the BELL's own arrays, which the
    plain version reads; ``colors``: the coloring the groups follow (the
    tensor a block Gauss-Seidel passes), None for the identity."""
    cols: torch.Tensor
    vals: torch.Tensor
    rowmap: torch.Tensor | None
    groups: tuple
    nb: int
    nbc: int
    blocksize: tuple
    width: int
    slices: int
    a_cols: torch.Tensor
    a_vals: torch.Tensor
    colors: object = None

    def rows(self, group):
        """The block rows of ``group`` (int64), in layout order."""
        first, n = self.groups[group]
        if self.rowmap is None:
            return torch.arange(first, first + n, device=self.vals.device)
        return self.rowmap[first:first + n].long()


def _grouping(colors, ncolors, nb):
    """(rows of each color, the int32 block row of each layout row, -1
    for the lanes past a group) of host ``colors``."""
    lab = np.asarray(colors, dtype=np.int64).reshape(-1)
    if lab.shape != (nb,) or (nb and (lab.min() < 0 or lab.max() >= ncolors)):
        raise ValueError(f"colors must be {nb} integers in 0..{ncolors - 1}")
    sizes = np.bincount(lab, minlength=ncolors)
    slices = -(-sizes // SLICE)
    first = SLICE * (np.cumsum(slices) - slices)
    start = np.cumsum(sizes) - sizes
    order = np.argsort(lab, kind="stable")
    g = lab[order]
    rowmap = np.full(SLICE * int(slices.sum()), -1, np.int32)
    rowmap[first[g] + np.arange(nb) - start[g]] = order
    return tuple(int(n) for n in sizes), tuple(int(f) for f in first), rowmap


def build_layout(A, colors=None, ncolors=None):
    """The ``BellLayout`` of the BELL A (tensors), with torch ops on A's
    device.  ``colors`` None: one group of every block row in order; else
    the ``ncolors`` colors (0 to ``ncolors - 1``, default the largest
    plus one) of the block rows of a square BELL, a tensor or an array,
    read on the host (set-up work: ``attach``), group g the rows of color
    g.  Raises ValueError where the coloring is not proper on the block
    graph (a row stores a block of another row of its color), which an
    in-place color pass needs."""
    br, bc = A.blocksize
    nb, nbc, W = A.n_block_rows, A.n_block_cols, A.width
    dev = A.vals.device
    cols = A.cols.to(torch.int64)
    cnt = A.row_nnz.to(torch.int64)
    if colors is None:
        sizes, first, rowmap = (nb,), (0,), None
        S = -(-nb // SLICE)
        src = torch.arange(S * SLICE, device=dev)
        live = src < nb
    else:
        host = colors.cpu() if isinstance(colors, torch.Tensor) else colors
        host = np.asarray(host)
        if ncolors is None:
            ncolors = int(host.max()) + 1 if nb else 0
        if nb != nbc or br != bc:
            raise ValueError("a coloring groups the rows of a square BELL "
                             "of square blocks")
        sizes, first, rowmap = _grouping(host, int(ncolors), nb)
        lab = torch.as_tensor(host, device=dev).to(torch.int64)
        stored = torch.arange(W, device=dev)[None, :] < cnt[:, None]
        own = torch.arange(nb, device=dev)[:, None]
        same = lab[cols] == lab[:, None]
        if bool(torch.any(stored & (cols != own) & same)):
            raise ValueError("the coloring is not proper on the block graph: "
                             "a block row stores a block of another row of "
                             "its own color, so its color pass cannot "
                             "update in place")
        rowmap = torch.as_tensor(rowmap, device=dev)
        S = rowmap.shape[0] // SLICE
        src = rowmap.to(torch.int64)
        live = src >= 0
        src = torch.where(live, src, 0)
    src = src.clamp(max=max(nb - 1, 0))
    # each layout row's slots: its stored blocks in order, then padding
    # slots of the BELL's (zero) block and its first stored block's column
    # (its own for a square BELL's row with none); the lanes past a group
    # hold row 0's, which no launch reads
    n = torch.where(live, cnt[src], 0)
    c = cols[src]
    stored = torch.arange(W, device=dev)[None, :] < n[:, None]
    own = src if nb == nbc else torch.zeros_like(src)
    head = torch.where(n > 0, c[:, 0], own) if W else own
    c = torch.where(stored, c, head[:, None])
    pcols = c.to(torch.int32).reshape(S, SLICE, W).transpose(1, 2) \
        .contiguous().reshape(-1)
    BB = br * bc
    v = A.vals.reshape(nb, W * BB)[src]
    pvals = v.reshape(S, SLICE, W, BB).permute(0, 2, 3, 1).contiguous() \
        .reshape(-1)
    return BellLayout(pcols, pvals, rowmap, tuple(zip(first, sizes)), nb,
                      nbc, (br, bc), W, S, A.cols, A.vals, colors)


def attach(A, colors=None, ncolors=None):
    """Build K7's layout of the BELL A (tensors; ``build_layout``, its rows
    grouped by ``colors`` if given) and keep it on A, where ``layout_of``
    and the block smoothers find it; return it.  Set-up work, done by
    ``MultilevelSolver.to_device``."""
    with _trace.span("bell.layout", rows=A.n_block_rows):
        L = build_layout(A, colors, ncolors)
    object.__setattr__(A, "_k7_layout", L)
    return L


def layout_of(A):
    """The layout kept on the BELL A (``attach``), which serves every
    product with A whatever its row order; a BELL placed outside a
    hierarchy gets the layout of its rows in order here, at its first
    product, with torch ops and no host read."""
    L = A.__dict__.get("_k7_layout")
    return attach(A) if L is None else L


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {                    # of csrc/bell_kernels.cu
    f"pyamg_bell_apply_{sfx}": [_VP, _VP, _I32, _VP, _I32, _I32, _I32, _I32,
                                _I32, _VP, _VP, _VP, _VP, ctypes.c_double,
                                _VP, _VP, _I32, _I32, _I32, _VP]
    for sfx in ("f32", "f64")}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One K7 launch: ``blocks`` blocks of ``threads`` threads (whole
    warps); thread t owns layout row ``row0 + t``."""
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def geometry(rows, sms=SM_COUNT):
    """K7's launch for ``rows`` block rows on a card of ``sms`` SMs: one
    thread a row, blocks of up to ``MAX_THREADS`` threads but small
    enough that a group of a few thousand rows still spreads over every
    SM."""
    threads = min(MAX_THREADS, max(SLICE, rows // sms // SLICE * SLICE))
    return Geometry(threads, max(1, -(-rows // threads)))


def _span(L, group):
    """(first layout row, layout rows) of a launch on ``group`` (None: the
    whole layout)."""
    if group is not None:
        return L.groups[group]
    return 0, (L.nb if L.rowmap is None else L.slices * SLICE)


def bell_apply_plain(L, x, mode="apply", b=None, dinv=None, omega=1.0,
                     group=None, mask=None):
    """Plain version of K7: the torch formula of the product (x's blocks
    gathered by block column, one einsum with the blocks), on the rows of
    ``group`` for a color pass (gathered, and the update scattered back
    into x), else on every row; then the mode's update (as
    ``bell_apply``; a masked Jacobi sweep updates the rows of ``mask``)."""
    br, bc = L.blocksize
    nb = L.nb
    rows = L.rows(group) if group is not None else None
    cols, vals = L.a_cols, L.a_vals
    if rows is not None:
        cols, vals = cols[rows], vals[rows]
    prod = torch.einsum("nwij,nwj->ni", vals, x.reshape(L.nbc, bc)[cols])
    if mode == "apply":
        return prod.reshape(nb * br)
    bb = b.reshape(nb, br)
    if mode == "residual":
        return (bb - prod).reshape(nb * br)
    D, xb = dinv, x.reshape(nb, br)
    if rows is not None:
        bb, D, xb = bb[rows], D[rows], xb[rows]
    new = xb + omega * torch.einsum("nij,nj->ni", D, bb - prod)
    if rows is not None:
        x.view(nb, br).index_copy_(0, rows, new)
        return x
    if mask is not None:
        new = torch.where(mask[:, None], new, xb)
    return new.reshape(nb * br)


def _check(L, x, mode, b, dinv, omega, group, mask):
    """Validate K7's operands (on every device, so the CPU tests reach
    the same checks)."""
    if not isinstance(L, BellLayout):
        raise TypeError("K7 takes a BellLayout")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    dtype, dev = L.vals.dtype, L.vals.device
    if dtype not in FLOATS:
        raise TypeError(f"K7 takes float32/float64, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    br, bc = L.blocksize
    if (mode == "gs_color") != (group is not None):
        raise ValueError("a color pass, and only a color pass, updates one "
                         "group (color)")
    if group is not None and not 0 <= group < len(L.groups):
        raise ValueError(f"group {group} of a layout of {len(L.groups)}")
    if mask is not None and (mode != "jacobi" or not isinstance(
            mask, torch.Tensor) or mask.dtype != torch.bool or
            tuple(mask.shape) != (L.nb,) or mask.device != dev):
        raise ValueError(f"a mask is a bool ({L.nb},) tensor on {dev}, for "
                         f"a Jacobi sweep")
    check_vector("x", x, (L.nbc * bc,), dtype, dev)
    if mode == "apply":
        if b is not None or dinv is not None:
            raise ValueError("mode 'apply' reads no b and no Dinv")
        return
    check_vector("b", b, (L.nb * br,), dtype, dev)
    if mode == "residual":
        if dinv is not None:
            raise ValueError("mode 'residual' reads no Dinv")
        return
    if br != bc or L.nbc != L.nb:
        raise ValueError(f"mode {mode!r} takes a square operator of square "
                         f"blocks, got {L.blocksize}")
    if not isinstance(dinv, torch.Tensor) or tuple(dinv.shape) != \
            (L.nb, br, br) or dinv.dtype != dtype or dinv.device != dev:
        raise ValueError(f"Dinv must be a ({L.nb}, {br}, {br}) {dtype} "
                         f"tensor on {dev}")
    if isinstance(omega, torch.Tensor):
        raise TypeError("omega is a Python number (a kernel argument)")


def bell_apply(L, x, mode="apply", b=None, dinv=None, omega=1.0,
               group=None, mask=None):
    """The block product of the ``BellLayout`` with x and the update
    ``mode`` asks for (``MODES``): on every block row a new (nb * br,)
    tensor; ``gs_color`` on the rows of color ``group`` alone, into x in
    place (returned); ``jacobi`` with a bool ``mask`` over block rows
    updates the rows of the mask and copies the others.  K7, one launch,
    on CUDA tensors; the plain version on CPU tensors."""
    _check(L, x, mode, b, dinv, omega, group, mask)
    br, bc = L.blocksize
    row0, nrows = _span(L, group)
    kind = "jacobi_indexed" if mask is not None else mode
    rows = L.groups[group][1] if group is not None else L.nb
    item = L.vals.element_size()
    launch.launched(bell_apply, (kind, L.nb, L.nbc, rows, br, bc, L.width,
                                 item))
    if mode == "gs_color":
        launch.tally(count_gs_passes, None)
    elif mask is None:
        launch.tally(count_bell_products,
                     (L.nb, L.nbc, br, bc, L.width, item))
    if L.vals.device.type == "cpu":
        return bell_apply_plain(L, x, mode, b, dinv, omega, group, mask)
    dev = L.vals.device
    if mode == "gs_color":
        y = x
    elif mask is not None:
        y = x.clone()
    else:
        y = torch.empty(L.nb * br, dtype=L.vals.dtype, device=dev)
    relax = MODES[mode] == 2
    dinv = dinv.contiguous() if relax else None
    # the residual of a block wider than the registers hold (kMaxSide)
    work = torch.empty(L.nb * br, dtype=L.vals.dtype, device=dev) \
        if relax and br > MAX_SIDE else None
    g = geometry(nrows, launch.sm_count(dev))
    fn = getattr(launch.library("bell_kernels", ENTRY_POINTS),
                 f"pyamg_bell_apply_{launch.suffix(L.vals.dtype)}")
    launch.check_rc(fn(
        L.cols.data_ptr(), L.vals.data_ptr(), L.width, ptr(L.rowmap), row0,
        nrows, L.nb, br, bc, x.data_ptr(), ptr(b), ptr(dinv), ptr(mask),
        float(omega), y.data_ptr(), ptr(work), MODES[mode], g.threads,
        g.blocks, launch.stream(dev)), "bell_apply")
    return y


launch.countable(bell_apply, store="bell_kernels.launches")

KERNELS = (bell_apply,)


def count_bell_products(counts):
    """Add {(block rows, block columns, br, bc, width, itemsize):
    products} to the store's counters: ``bell.products`` and one counter
    a shape, ``bell.products[nb=..,nbc=..,bs=BRxBC,w=..,item=..]``."""
    for (nb, nbc, br, bc, width, itemsize), k in counts.items():
        _trace.count(f"bell.products[nb={nb},nbc={nbc},bs={br}x{bc},"
                     f"w={width},item={itemsize}]", k)
    _trace.count("bell.products", sum(counts.values()))


def count_gs_passes(counts):
    """Add the block Gauss-Seidel color passes ({key: passes}) to the
    store's counter ``bell.gs_passes``."""
    _trace.count("bell.gs_passes", sum(counts.values()))
