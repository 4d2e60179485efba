"""CUDA kernel K6 (a sparse product over a sliced layout, with the vector
update around it fused in) for the distributed V-cycle, its plain PyTorch
version, its layout, its launch geometry and its launch counters.

No JAX counterpart file: the JAX package writes the distributed V-cycle's
products as ``jnp`` gathers over the padded level arrays
(``pyamg_tpu/parallel/dist_setup.py:87-125``), which XLA fuses into one
pass.  Run as eager torch ops over the same arrays, each product was
about ten (rows x width) temporaries, and the levels are mostly padding.

K6 ``dist_slice_apply`` reads a ``SliceLayout``: rows in slices of 32
(one warp a slice), each slice as wide as the most stored entries among
its rows, a row's entries packed to the front in their stored order, and
the entries column-major within a slice (slot k of the 32 rows
contiguous).  Columns are int32 indices into the vector the product
reads.  ``slice_layouts`` builds the layouts of several operators from
their padded ``(columns, values, kept)`` arrays with torch ops on their
device and one host read in all (the layouts' sizes).

One launch computes ``y = A src`` and one update after it, by ``mode``:
``apply`` (``A src``), ``residual`` (``b - A src``), ``jacobi``
(``x + w * (b - A src)``) or ``correct`` (``x + A src``); ``jacobi0`` is
``jacobi`` from x = 0 (``0 + w * b``: A 0 sums to +0 for a finite A), with
no product and no src.  Every lane
walks its slice's whole width; padding slots hold 0 and a column of
their own row.  ``csrc/dist_kernels.cu`` says why the result equals the
plain version's bit for bit.

The kernel lives in ``csrc/dist_kernels.cu``, built and called through
``ops/launch.py``.  The wrapper given CUDA tensors launches the kernel or
raises; given CPU tensors it runs the plain version.  ``launches`` counts
the kernels it launched, ``by_op`` the same keyed by ``(rows, width sum,
mode)``, and each launch bumps the store's counter
``dist_kernels.launches`` (``launch.countable``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import launch
from .launch import SM_COUNT, check_vector, ptr

_FLOATS = (torch.float32, torch.float64)
SLICE = 32                  # rows a slice: one warp
MAX_THREADS = 256           # threads a block, at most (kMaxThreads)
MODES = {"apply": 0, "residual": 1, "jacobi": 2, "correct": 3,
         "jacobi0": 4}
# the vectors of each mode's update, besides the product's source (which
# jacobi0, the sweep from x = 0, does not read)
_NEEDS = {"apply": (), "residual": ("b",), "jacobi": ("x", "b", "w"),
          "correct": ("x",), "jacobi0": ("b", "w")}


@dataclasses.dataclass(frozen=True)
class SliceLayout:
    """An operator of ``rows`` rows as slices of 32 rows: ``cols`` (int32)
    and ``vals`` of ``32 * width_sum`` slots, slice s holding slots
    ``[sptr[s], sptr[s + 1])`` (int64), slot k of its lane l at
    ``sptr[s] + 32 k + l``.  ``src_len``: the length of the vector the
    columns index; ``max_width``: the widest slice."""
    cols: torch.Tensor
    vals: torch.Tensor
    sptr: torch.Tensor
    rows: int
    width_sum: int
    max_width: int
    src_len: int

    @property
    def slices(self):
        return self.sptr.shape[0] - 1


def _slice_widths(keep):
    """(the count of kept entries of each row, the width of each slice:
    the largest count among its 32 rows) of the (rows, W) mask ``keep``,
    both int64."""
    n = keep.shape[0]
    cnt = torch.sum(keep, dim=1)
    pad = -(-n // SLICE) * SLICE - n
    return cnt, torch.amax(torch.nn.functional.pad(cnt, (0, pad)).view(
        -1, SLICE), dim=1)


def _pack(idx, vals, keep, cnt, widths, width_sum, max_width, src_len):
    """The ``SliceLayout`` of the rows of (idx, vals) where ``keep``, once
    the sizes are known on the host."""
    n, W = keep.shape
    dev = keep.device
    S = widths.shape[0]
    E = SLICE * width_sum
    sptr = torch.zeros(S + 1, dtype=torch.int64, device=dev)
    sptr[1:] = torch.cumsum(widths, dim=0) * SLICE
    rows = torch.arange(n, device=dev)
    # every slot first: value 0, a column of its own row (the row's first
    # kept one, 0 where it keeps none)
    first = torch.gather(idx, 1, torch.argmax(keep.to(torch.uint8), dim=1,
                                              keepdim=True))[:, 0]
    first = torch.where(cnt > 0, first, 0)
    first = torch.nn.functional.pad(first, (0, S * SLICE - n))
    group = torch.repeat_interleave(torch.arange(S, device=dev), widths,
                                    output_size=width_sum)
    lane = torch.arange(SLICE, device=dev)
    slot_row = (group[:, None] * SLICE + lane).reshape(-1)
    cols = torch.zeros(E + 1, dtype=torch.int32, device=dev)
    out = torch.zeros(E + 1, dtype=vals.dtype, device=dev)
    cols[:E] = first[slot_row].to(torch.int32)
    # then the kept entries, packed to the front of their row in stored
    # order; the others go to slot E, cut off below
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = sptr[rows // SLICE][:, None] + pos * SLICE + \
        (rows % SLICE)[:, None]
    dest = torch.where(keep, dest, E).reshape(-1)
    cols[dest] = idx.reshape(-1).to(torch.int32)
    out[dest] = vals.reshape(-1)
    return SliceLayout(cols[:E].contiguous(), out[:E].contiguous(), sptr, n,
                       width_sum, max_width, src_len)


def slice_layouts(operators, read):
    """The ``SliceLayout`` of each of ``operators``, a list of ``(idx,
    vals, keep, src_len)``: (rows, W) indices into the vector of length
    ``src_len`` the product reads (in range where ``keep``), values and
    the mask of stored entries.  Torch ops on their device; ``read(t)``
    brings the one tensor of sizes to the host (a list)."""
    parts = [_slice_widths(keep) for _, _, keep, _ in operators]
    sizes = []
    for _, widths in parts:
        sizes += [torch.sum(widths), torch.amax(widths) if widths.numel()
                  else widths.new_zeros(())]
    sizes = read(torch.stack(sizes))
    return [_pack(idx, vals, keep, cnt, widths, int(sizes[2 * i]),
                  int(sizes[2 * i + 1]), int(src_len))
            for i, ((idx, vals, keep, src_len), (cnt, widths))
            in enumerate(zip(operators, parts))]


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {                    # of csrc/dist_kernels.cu
    f"pyamg_dist_slice_apply_{sfx}": [_VP, _VP, _VP, _I32, _VP, _VP, _VP,
                                      _VP, _VP, _I32, _I32, _I32, _VP]
    for sfx in ("f32", "f64")}


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One K6 launch: ``blocks`` blocks of ``threads`` threads (whole
    warps); thread t owns row t, lane t % 32 of slice t // 32."""
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def geometry(rows, sms=SM_COUNT):
    """K6's launch for ``rows`` rows on a card of ``sms`` SMs: one thread
    a row, blocks of up to ``MAX_THREADS`` threads but small enough that a
    level of a few thousand rows still spreads over every SM."""
    threads = min(MAX_THREADS, max(SLICE, rows // sms // SLICE * SLICE))
    return Geometry(threads, max(1, -(-rows // threads)))


def dist_slice_apply_plain(layout, src, mode="apply", x=None, b=None,
                           w=None):
    """Plain version of K6: each row's slice walked slot by slot, the
    products rounded and added in slot order from 0, then the mode's
    update."""
    L = layout
    if mode == "jacobi0":
        return w * b + 0.0
    dev = L.vals.device
    rows = torch.arange(L.rows, device=dev)
    s = rows // SLICE
    base = L.sptr[s] + rows % SLICE
    width = (L.sptr[1:] - L.sptr[:-1])[s] // SLICE
    acc = torch.zeros(L.rows, dtype=L.vals.dtype, device=dev)
    for k in range(L.max_width):
        live = k < width
        j = torch.where(live, base + SLICE * k, 0)
        term = L.vals[j] * src[L.cols[j].to(torch.int64)]
        acc = torch.where(live, acc + term, acc)
    if mode == "residual":
        return b - acc
    if mode == "jacobi":
        return x + w * (b - acc)
    if mode == "correct":
        return x + acc
    return acc


def _check(layout, src, mode, vectors):
    """Validate K6's operands (on every device, so the CPU tests reach the
    same checks): src of ``src_len`` values, and exactly the vectors of
    ``rows`` values that the mode's update reads."""
    if not isinstance(layout, SliceLayout):
        raise TypeError("K6 takes a SliceLayout")
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {sorted(MODES)}")
    dtype, dev = layout.vals.dtype, layout.vals.device
    if dtype not in _FLOATS:
        raise TypeError(f"K6 takes float32/float64, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if mode == "jacobi0":
        if src is not None:
            raise ValueError("mode 'jacobi0' reads no src")
    else:
        check_vector("src", src, (layout.src_len,), dtype, dev)
    for name, v in vectors.items():
        if (v is not None) != (name in _NEEDS[mode]):
            raise ValueError(f"mode {mode!r} takes {_NEEDS[mode] or 'no'} "
                             f"vectors besides src; {name} is "
                             f"{'missing' if v is None else 'extra'}")
        if v is not None:
            check_vector(name, v, (layout.rows,), dtype, dev)


def dist_slice_apply(layout, src, mode="apply", x=None, b=None, w=None):
    """The product of the ``SliceLayout`` with ``src`` and the update
    ``mode`` asks for (``MODES``), as a new (rows,) tensor: K6, one launch,
    on CUDA tensors; the plain version on CPU tensors."""
    _check(layout, src, mode, {"x": x, "b": b, "w": w})
    L = layout
    if L.vals.device.type == "cpu":
        return dist_slice_apply_plain(L, src, mode, x, b, w)
    dev = L.vals.device
    y = torch.empty(L.rows, dtype=L.vals.dtype, device=dev)
    g = geometry(L.rows, launch.sm_count(dev))
    fn = getattr(launch.library("dist_kernels", ENTRY_POINTS),
                 f"pyamg_dist_slice_apply_{launch.suffix(L.vals.dtype)}")
    launch.check_rc(fn(
        L.cols.data_ptr(), L.vals.data_ptr(), L.sptr.data_ptr(), L.rows,
        ptr(src), ptr(x), ptr(b), ptr(w), y.data_ptr(), MODES[mode],
        g.threads, g.blocks, launch.stream(dev)), "dist_slice_apply")
    launch.launched(dist_slice_apply, (L.rows, L.width_sum, mode))
    return y


launch.countable(dist_slice_apply, store="dist_kernels.launches")

KERNELS = (dist_slice_apply,)
