"""CUDA kernels K1 (banded SpMV) and K2 (multicolor GS sweep) for DIA
operators, their plain PyTorch versions, their launch geometries, and their
launch counters.

Counterpart of ``pyamg_tpu/ops/pallas_kernels.py``.

K1 ``dia_spmv`` replaces the TPU kernel ``_dia_call`` (behind
``dia_spmv_pallas``).  It is bound by bytes on the H100: it reads
``ndiag*n`` matrix values plus x and writes y, ~2 flops per value.  A
thread owns the rows of 16 bytes (4 float32, 2 float64), loads its row
group of every diagonal of the band (one 16-byte load each) and the x
values they multiply before it uses any, and takes its offsets by value
from a kernel parameter.  An x of shape ``(n, k)`` is one launch that
reads the band once.  ``spmv_geometry`` gives the launch shape (plain
Python, reached by the CPU tests).

K2 ``dia_gs_sweep`` replaces ``_dia_gs_call``, which ran every color pass
of a sweep in one TPU grid with x resident in VMEM.  Here too one launch
runs every pass of the sweep: rows are cut into contiguous ranges, one
per resident block, and before each pass a block waits only for the rows
of other blocks within its halo (``max |offset|`` rows).  In the staged
regime a block keeps its rows of the band, b, Dinv, colors and x in
shared memory, so the band is read from device memory once per sweep,
and the rows other blocks read pass between blocks as tagged words (the
value beside the pass that wrote it); where the band does not fit, or
reaches past the next block, each pass reads it again, still in one
launch, and the blocks wait for each other through pass counters.  A
block waits for the blocks whose rows it reads and for those that read
its rows.  ``gs_geometry`` picks the regime and the
launch shape (plain Python, reached by the CPU tests);
``csrc/dia_kernels.cu`` says why the result equals the plain version's
bit for bit.

Both take any number of diagonals and x of shape ``(n,)`` or ``(n, k)``;
on CUDA tensors K2 runs once per column of a 2-D x.

The kernels live in ``csrc/dia_kernels.cu``, built with ``nvcc`` for
``sm_90a`` at first use (``_native/build.py``) and called through a plain
C ABI with ctypes.  A wrapper given CUDA tensors launches its kernel or
raises; given CPU tensors it runs the plain version.  Each wrapper's
``launches`` counts the kernels it launched (one per K1 product and one
per K2 sweep and column of x), and its ``by_op`` the same per operator,
keyed by ``(n, ndiag)``; ``dia_gs_sweep.passes`` counts the color passes
K2 ran, keyed the same.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import os

import torch

from .._native.build import cuda_library

SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "dia_kernels.cu")

_FLOATS = (torch.float32, torch.float64)

# the H100 SXM (data sheet): SMs, and the dynamic shared memory one block
# may use (kMaxSmem); the wrapper passes the card's own SM count
SM_COUNT = 132
MAX_SMEM = 232_448
SPMV_THREADS = 256          # K1 threads a block, at most (kSpmvThreads)
MAX_THREADS = 1024          # K2 threads a block, at most (kMaxThreads)
FLAG_BLOCKS = 1024          # entries of a pass-counter array (kMaxFlagBlocks)
GS_MIN_ROWS = 128           # rows a K2 block takes, at least


def build() -> dict:
    """Compile ``csrc/dia_kernels.cu`` (unless this source was built with
    these flags already) and return ``{"path", "seconds", "log"}``;
    ``log`` holds the compiler's register/spill report when a build ran."""
    return cuda_library(SOURCE, "dia_kernels")


@functools.cache
def _lib():
    return bind(build()["path"])


def bind(path):
    """The library at ``path`` built from ``csrc/dia_kernels.cu``, its
    entry points typed for ctypes, and ``spmv_capacity``: the most
    offsets a K1 launch takes by value."""
    lib = ctypes.CDLL(path)
    vp, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_uint)
    for suffix, real in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        spmv = getattr(lib, f"pyamg_dia_spmv_{suffix}")
        spmv.restype = i32
        spmv.argtypes = [vp, i32, i64, vp, vp, i32, i32, vp, vp, i32, i32,
                         vp]
        gs = getattr(lib, f"pyamg_dia_gs_sweep_{suffix}")
        gs.restype = i32
        gs.argtypes = [vp, i32, i64, vp, i32, vp, vp, vp, vp, i32, real,
                       vp, vp, vp, vp, vp, u32, i32, i32, i32, i32, i32,
                       i32, i32, vp]
    lib.pyamg_dia_spmv_capacity.restype = i32
    lib.pyamg_dia_spmv_capacity.argtypes = []
    lib.spmv_capacity = lib.pyamg_dia_spmv_capacity()
    return lib


def _suffix(dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


_INTS = {}


def _device_ints(values, device):
    """An int32 tensor of ``values`` on ``device``, made once per tuple."""
    key = (tuple(values), device)
    t = _INTS.get(key)
    if t is None:
        t = _INTS[key] = torch.tensor([int(v) for v in values],
                                      dtype=torch.int32, device=device)
    return t


@functools.lru_cache(maxsize=None)
def _host_ints(values):
    """A ctypes int32 array of ``values`` (a tuple), made once per tuple."""
    return (ctypes.c_int * len(values))(*(int(v) for v in values))


def _check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _check_vector(name, v, shape, dtype, device):
    if not isinstance(v, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(v.shape)}, expected "
                         f"{tuple(shape)}")
    if v.dtype != dtype:
        raise TypeError(f"{name} has dtype {v.dtype}, expected {dtype}")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    if not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_band(data, offsets, n, x):
    """Validate the DIA operands of both kernels (on every device, so the
    CPU tests reach the same checks): x is ``(n,)`` or ``(n, k)``."""
    if not isinstance(data, torch.Tensor) or not isinstance(x, torch.Tensor):
        raise TypeError("DIA kernels take torch tensors")
    if data.dtype not in _FLOATS:
        raise TypeError(f"DIA kernels take float32/float64, got {data.dtype}")
    if data.ndim != 2 or len(offsets) < 1 or \
            data.shape[0] != len(offsets) or data.shape[1] < n:
        raise ValueError(f"data shape {tuple(data.shape)} does not hold "
                         f"{len(offsets)} diagonals of {n} rows")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n},) or "
                         f"({n}, k)")
    _check_vector("x", x, x.shape, data.dtype, data.device)
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def _columns(fn, x, *more):
    """``fn`` on each column of a 2-D x (and of the 2-D tensors in
    ``more``), the results stacked as columns; ``fn(x, *more)`` for 1-D."""
    if x.ndim == 1:
        return fn(x, *more)
    return torch.stack([fn(*(t[:, j].contiguous() for t in (x, *more)))
                        for j in range(x.shape[1])], dim=1)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# K1: banded SpMV
# ---------------------------------------------------------------------------

def dia_spmv_plain(data, offsets, n, x):
    """Plain version of K1: a sum of shifted elementwise products, for x
    of shape ``(n,)`` or ``(n, k)`` (padded along dim 0)."""
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    xp = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (lo, hi))
    col = (slice(None),) + (None,) * (x.ndim - 1)
    acc = None
    for d, off in enumerate(offsets):
        term = data[d, :n][col] * xp[lo + off:lo + off + n]
        acc = term if acc is None else acc + term
    return acc


@dataclasses.dataclass(frozen=True)
class SpmvGeometry:
    """One K1 launch: ``blocks`` blocks of ``threads`` threads.  Thread t
    computes column ``t % k`` of the row group ``t // k``, rows ``[g *
    rows, min(n, (g + 1) * rows))``, where ``rows`` values fill 16 bytes;
    ``vector``: the band's row groups are 16-byte loads (``npad`` a
    multiple of ``rows``; the kernel also checks the pointers)."""
    rows: int
    threads: int
    blocks: int
    vector: bool


@functools.lru_cache(maxsize=None)
def spmv_geometry(n, k, npad, itemsize, sms=SM_COUNT):
    """K1's launch for ``n`` rows of ``k`` columns of ``itemsize``-byte
    values and a band of row stride ``npad``, on a card of ``sms`` SMs:
    one thread per 16 bytes of rows and column, blocks of up to
    ``SPMV_THREADS`` threads but small enough that there are at least
    ``sms`` blocks where there are ``32 * sms`` threads (a 28,000-row
    level still spreads over every SM)."""
    rows = 16 // itemsize
    work = -(-n // rows) * k
    threads = min(SPMV_THREADS, max(32, work // sms // 32 * 32))
    return SpmvGeometry(rows, threads, max(1, -(-work // threads)),
                        npad % rows == 0)


def dia_spmv(data, offsets, n, x):
    """y = A @ x for the DIA operator ``(data, offsets)`` of logical size
    ``n`` and x of shape ``(n,)`` or ``(n, k)`` (K1, one launch, on CUDA
    tensors; the plain version on CPU tensors)."""
    _check_band(data, offsets, n, x)
    if data.device.type == "cpu":
        return dia_spmv_plain(data, offsets, n, x)
    dev = data.device
    lib = _lib()
    k = 1 if x.ndim == 1 else x.shape[1]
    g = spmv_geometry(n, k, data.shape[1], data.element_size(),
                      _sm_count(dev))
    offs = tuple(int(o) for o in offsets)
    # past the by-value capacity, the offsets go through device memory
    far = _device_ints(offs, dev).data_ptr() \
        if len(offs) > lib.spmv_capacity else None
    y = torch.empty_like(x)
    _check(getattr(lib, f"pyamg_dia_spmv_{_suffix(data.dtype)}")(
        data.data_ptr(), len(offs), data.shape[1], _host_ints(offs), far, n,
        k, x.data_ptr(), y.data_ptr(), g.threads, g.blocks, _stream(dev)),
        "dia_spmv")
    dia_spmv.launches += 1
    dia_spmv.by_op[(n, len(offs))] += 1
    return y


dia_spmv.launches = 0
dia_spmv.by_op = collections.Counter()


# ---------------------------------------------------------------------------
# K2: multicolor Gauss-Seidel sweep
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GsGeometry:
    """One K2 launch: ``blocks`` blocks of ``threads`` threads, block k
    owning rows ``[k * rows, min(n, (k + 1) * rows))`` and reading, before
    each pass, the rows within ``halo`` (max |offset|) of its own, which
    lie in the ``reach`` blocks on each side.  ``staged``: the block's
    rows of the band, b, Dinv, colors and x live in ``smem`` bytes of
    shared memory, and the rows other blocks read pass between blocks as
    tagged words (a block polls those ``staged_reads`` gives); else every
    pass reads everything from device memory and the blocks wait for each
    other through pass counters."""
    staged: bool
    blocks: int
    threads: int
    rows: int
    reach: int
    halo: int
    smem: int

    def row_range(self, k, n):
        return k * self.rows, min(n, (k + 1) * self.rows)

    def waits_for(self, k):
        """The blocks whose previous pass block k may wait for."""
        lo = max(0, k - self.reach)
        hi = min(self.blocks, k + self.reach + 1)
        return [j for j in range(lo, hi) if j != k]


def staged_reads(offsets, lo, hi, halo, n):
    """The rows outside ``[lo, hi)`` that a staged block owning those rows
    polls before each pass (the kernel's ``need``), as sorted disjoint
    ``(start, stop)`` ranges: those within ``halo`` of its edges that a
    diagonal or a diagonal's negation reaches from its rows.  The negated
    reach makes a block wait for every block that reads its rows."""
    spans = []
    for off in {*offsets, *(-o for o in offsets)}:
        a, e = lo + off, hi + off
        for s, t in ((max(a, lo - halo), min(e, lo)),
                     (max(a, hi), min(e, hi + halo))):
            s, t = max(s, 0), min(t, n)
            if s < t:
                spans.append((s, t))
    merged = []
    for s, t in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t))
        else:
            merged.append((s, t))
    return merged


def gs_smem(staged, rows, ndiag, halo, itemsize):
    """Shared-memory bytes of a K2 block (``gs_smem`` in the CUDA source):
    when staged, for each of its rows the band, b, omega * Dinv and colors,
    two buffers of x holding its rows and ``halo`` more on each side, and
    a byte for each halo row; then the offsets."""
    staged_bytes = rows * ((ndiag + 2) * itemsize + 4) + \
        2 * (rows + 2 * halo) * itemsize + 2 * halo
    return (staged_bytes if staged else 0) + 4 * ndiag


def _round_up(v, m):
    return -(-v // m) * m


def _gs_shape(n, blocks, ndiag, halo, itemsize, staged,
              threads=MAX_THREADS):
    """A K2 launch of at most ``blocks`` blocks of at most ``threads``
    threads over ``n`` rows (whole warps of rows each), ``staged`` or
    not."""
    rows = _round_up(-(-n // blocks), 32)
    blocks = -(-n // rows)
    return GsGeometry(staged, blocks, min(threads, rows), rows,
                      min(blocks - 1, -(-halo // rows)), halo,
                      gs_smem(staged, rows, ndiag, halo, itemsize))


@functools.lru_cache(maxsize=None)
def gs_geometry(n, ndiag, halo, itemsize, sms=SM_COUNT, max_smem=MAX_SMEM):
    """K2's launch for ``n`` rows, ``ndiag`` diagonals reaching ``halo``
    rows, ``itemsize``-byte values, on a card of ``sms`` SMs: one block
    per SM, fewer where a block would take under ``GS_MIN_ROWS`` rows.
    Staged where a block's rows fit in ``max_smem`` bytes of shared memory
    and the band reaches no further than the next block (``halo <=
    rows``); else one block per SM reading the band each pass.  Where the
    band reaches further, every row of a staged block is read by other
    blocks each pass, and reading the band again from L2 costs less than
    exchanging the block as tagged words (PERF.md, section 6)."""
    blocks = min(sms, max(1, -(-n // GS_MIN_ROWS)))
    g = _gs_shape(n, blocks, ndiag, halo, itemsize, True)
    if g.smem <= max_smem and halo <= g.rows:
        return g
    return _gs_shape(n, sms, ndiag, halo, itemsize, False)


class _Exchange:
    """What K2's launches on one stream share: the pass counters
    (``FLAG_BLOCKS`` int32), the tagged words (grown to the largest need
    seen, zeroed when made) and the epoch, which every launch raises past
    all the counter values and tags it writes."""

    def __init__(self, device):
        self.device = device
        self.flags = torch.zeros(FLAG_BLOCKS, dtype=torch.int32,
                                 device=device)
        self.words = torch.zeros(0, dtype=torch.int64, device=device)
        self.epoch = 1

    def words_for(self, count):
        if self.words.numel() < count:
            self.words = torch.zeros(count, dtype=torch.int64,
                                     device=self.device)
        return self.words

    def begin(self, passes):
        """The epoch of a launch of ``passes`` passes; the next launch's
        lies past every counter value and tag this one writes."""
        if self.epoch + passes + 1 >= 1 << 32:     # start afresh
            self.flags.zero_()
            self.words.zero_()
            self.epoch = 1
        epoch = self.epoch
        self.epoch += passes + 1
        return epoch


_EXCHANGES = {}


def _exchange(device, stream):
    key = (device, stream)
    if key not in _EXCHANGES:
        _EXCHANGES[key] = _Exchange(device)
    return _EXCHANGES[key]


def dia_gs_sweep_plain(data, offsets, n, x, b, Dinv, colors, order, omega):
    """Plain version of K2: the color-pass loop of
    ``relaxation.gauss_seidel`` on a DIA operator (x and b ``(n,)`` or
    ``(n, k)``)."""
    if x.ndim == 2:
        Dinv, colors = Dinv[:, None], colors[:, None]
    for c in order:
        r = b - dia_spmv_plain(data, offsets, n, x)
        upd = x + omega * Dinv * r
        x = torch.where(colors == c, upd, x)
    return x


def _gs_launch(g, data, offsets, n, x, b, Dinv, colors, order, omega,
               lib=None):
    """Launch K2 once with geometry ``g`` on 1-D CUDA operands already
    checked (through ``lib``, by default the built source), and return the
    new x.  Counts nothing: the wrapper does."""
    dev = data.device
    out = torch.empty_like(x)
    stream = _stream(dev)
    ex = _exchange(dev, stream)
    words = scratch = None
    if g.staged:
        words = ex.words_for(2 * n * (data.element_size() // 4))
    elif len(order) > 1:
        scratch = torch.empty_like(x)
    fn = getattr(lib or _lib(), f"pyamg_dia_gs_sweep_{_suffix(data.dtype)}")
    rc = fn(data.data_ptr(), len(offsets), data.shape[1],
            _device_ints(offsets, dev).data_ptr(), n, b.data_ptr(),
            Dinv.data_ptr(), colors.data_ptr(),
            _device_ints(order, dev).data_ptr(), len(order), float(omega),
            x.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            None if words is None else words.data_ptr(),
            ex.flags.data_ptr(), ex.begin(len(order)), int(g.staged),
            g.blocks, g.threads, g.rows, g.reach, g.halo, g.smem, stream)
    _check(rc, "dia_gs_sweep")
    return out


def dia_gs_sweep(data, offsets, n, x, b, Dinv, colors, order, omega=1.0):
    """Run the color passes ``order`` of multicolor GS on the DIA operator
    ``(data, offsets)``: for each pass, rows with ``colors == order[p]``
    get ``x += omega * Dinv * (b - A x)`` from the current x.  x and b are
    ``(n,)`` or ``(n, k)``.  Returns the new x (K2, one launch per sweep
    and column, on CUDA tensors; the plain version on CPU tensors)."""
    _check_band(data, offsets, n, x)
    _check_vector("b", b, x.shape, data.dtype, data.device)
    _check_vector("Dinv", Dinv, (n,), data.dtype, data.device)
    _check_vector("colors", colors, (n,), torch.int32, data.device)
    if data.device.type == "cpu":
        return dia_gs_sweep_plain(data, offsets, n, x, b, Dinv, colors,
                                  order, omega)
    if len(order) == 0:
        return x.clone()
    halo = max(abs(int(o)) for o in offsets)
    g = gs_geometry(n, len(offsets), halo, data.element_size(),
                    _sm_count(data.device))
    key = (n, len(offsets))

    def one(xc, bc):
        out = _gs_launch(g, data, offsets, n, xc, bc, Dinv, colors, order,
                         omega)
        dia_gs_sweep.launches += 1          # one kernel per sweep
        dia_gs_sweep.by_op[key] += 1
        dia_gs_sweep.passes[key] += len(order)
        return out

    return _columns(one, x, b)


@functools.cache
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


dia_gs_sweep.launches = 0
dia_gs_sweep.by_op = collections.Counter()
dia_gs_sweep.passes = collections.Counter()

KERNELS = (dia_spmv, dia_gs_sweep)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
        k.by_op.clear()
    dia_gs_sweep.passes.clear()
