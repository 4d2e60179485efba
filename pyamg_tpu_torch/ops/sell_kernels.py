"""CUDA kernels K3/K4 (SELL SpMV) and K5 (hybrid Gauss-Seidel sweep on a
square SELL), their plain PyTorch versions, their launch geometry and
their launch counters.

Counterpart of ``pyamg_tpu/ops/sell_kernels.py``.

``sell_spmv`` replaces both TPU SpMV kernels, ``_spmv_call`` (K3, x
resident in VMEM) and ``_spmv_tiled_call`` (K4, x streamed in row tiles
past the 6 MB VMEM budget): on the H100 one kernel reads x from device
memory at any size.  ``sell_gs_sweep`` replaces ``_gs_call``: 1024-row
tiles in order (reversed for ``backward``, forward then backward for
``symmetric``), Gauss-Seidel across tiles and Jacobi within one.

What bounds them on the H100, and the designs (``csrc/sell_kernels.cu``
has the details): both move 12 bytes per plan slot for 2 flops, so bytes
bound them once enough loads are in flight; a thread that walks a row's
passes in series is bound by load latency instead.  So K3 keeps one
thread per row only for a wide, short operator, and otherwise gives each
128-row slab a cluster of ``cluster`` blocks of ``groups`` pass-groups
that stage the rounded products in shared memory for one owner per row
to add in pass order.  K5 runs one cluster of 8 blocks (one per sublane
of the 1024-row tile) that streams the coming passes' values and deltas
through a shared-memory ring filled by TMA, and keeps x in shared memory
where it fits beside two stages of a tile's passes.  Both sum in the
plain version's order, so kernel and plain version agree bit for bit.

``spmv_geometry`` and ``gs_geometry`` compute each launch's shape from
the plan's sizes (plain Python, reached by the CPU tests);
``spmv_schedule`` and ``gs_schedule`` replay the kernels' index
arithmetic on that shape, so the tests can check that every slot is
computed once and every row summed in pass order.

The kernels live in ``csrc/sell_kernels.cu``, built and called through
``ops/launch.py``.  A wrapper given CUDA tensors launches its kernel or
raises; given CPU tensors it runs the plain version.
``sell_spmv.launches`` counts one per product, ``sell_gs_sweep.launches``
one per directional sweep; each wrapper's ``by_op`` counts the same
launches per plan, keyed by ``plan_key`` (``launch.countable``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from . import launch
from .launch import MAX_SMEM, SM_COUNT, check_vector
from ..sparse.sell import LANE, SELL

GS_TILE = 8 * LANE          # rows per Gauss-Seidel tile (kGsTile)
GS_CLUSTER = GS_TILE // LANE   # K5 blocks: one per sublane (kGsCluster)
_SWEEPS = {"forward": (0,), "backward": (1,), "symmetric": (0, 1)}
MAX_CLUSTER = 8             # the portable cluster size
K3_THREADS = SM_COUNT * 1024   # threads K3 aims to put on the card (its
                               # staged form holds 64 registers a thread)
K3_MIN_PASSES = 2           # a K3 thread takes at least this many passes
K3_MAX_CHUNK = 128          # passes a K3 block stages per round
K3_DIRECT_SLABS = 2         # slabs of a one-thread-per-row block (kDirectSlabs)
K5_MAX_CHUNK = 256          # passes of a chunk (a TMA box's rows)
K5_MAX_STAGES = 4           # stages of K5's ring (the kernel takes 2 to 4)
K5_STATIC_SMEM = 128        # its static shared memory (mbarriers; ptxas)
_BATCH = 8                  # passes whose loads a K3 thread issues together


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ENTRY_POINTS = {                    # of csrc/sell_kernels.cu
    "pyamg_sell_spmv_f32": [_VP, _VP, _VP, _I32, _I64, _I32, _I32, _I32,
                            _I32, _I32, _VP, _VP, _I32, _I32, _I32, _I32,
                            _I32, _I32, _I32, _VP],
    "pyamg_sell_gs_sweep_f32": [_VP, _VP, _VP, _I32, _I64, _I32, _VP, _VP,
                                ctypes.c_float, _I32, _VP, _I32, _I32, _I32,
                                _I32, _I32, _I32, _VP]}


def plan_key(A):
    """(kind, t, passes, Sy, shape): the key of a plan in ``by_op`` (the
    shape tells apart the small plans of a deep hierarchy, which share the
    rest)."""
    return (A.kind, A.t, A.n_passes, A.Sy, tuple(A.shape))


def _pow2_floor(v):
    return 1 << (max(1, int(v)).bit_length() - 1)


# ---------------------------------------------------------------------------
# Launch geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpmvGeometry:
    """One K3 launch: ``slabs`` clusters of ``cluster`` blocks, each block
    ``groups`` x 128 threads; block r of a cluster stages ``chunk`` passes
    per round, over ``rounds`` rounds, in ``buffers`` alternating stages."""
    slabs: int
    groups: int
    cluster: int
    chunk: int
    rounds: int
    buffers: int

    @property
    def direct(self):
        """One thread per row, summing in registers, no cluster."""
        return self.groups == 1 and self.cluster == 1

    @property
    def threads(self):
        return K3_DIRECT_SLABS * LANE if self.direct else self.groups * LANE

    @property
    def blocks(self):
        if self.direct:
            return -(-self.slabs // K3_DIRECT_SLABS)
        return self.slabs * self.cluster

    @property
    def smem(self):
        if self.direct:
            return 0
        gathered = 1 if self.cluster > 1 else 0
        return (self.buffers + gathered) * self.chunk * LANE * 4


@functools.lru_cache(maxsize=None)
def spmv_geometry(T, n):
    """K3's launch for a plan of ``T`` passes and ``n`` rows.  Aim at
    ``K3_THREADS`` threads with at least ``K3_MIN_PASSES`` passes each: a
    cluster (up to 8 blocks) where one block per slab leaves SMs idle,
    then pass-groups (up to 8).  A wide, short operator keeps one thread
    per row."""
    slabs = -(-n // LANE)
    want = max(1, min(K3_THREADS // (slabs * LANE), T // K3_MIN_PASSES))
    cluster = _pow2_floor(min(want, MAX_CLUSTER, max(1, SM_COUNT // slabs)))
    groups = _pow2_floor(min(want // cluster, 8))
    per_block = -(-T // cluster)
    rounds = -(-per_block // K3_MAX_CHUNK)
    chunk = -(-per_block // rounds)
    return SpmvGeometry(slabs, groups, cluster, chunk, rounds,
                        2 if rounds > 1 else 1)


def spmv_schedule(g, T):
    """Replay K3's index arithmetic: ``(count, order, owners)``, where
    ``count[p, i]`` is how often the product of pass p and padded row i
    is computed, ``order`` the passes in the order a row's owner adds
    them, and ``owners[l]`` how many threads of a slab's cluster own lane
    l."""
    count = np.zeros((T, g.slabs * LANE), np.int32)
    for k in range(g.rounds):
        for rank in range(g.cluster):
            p0 = (k * g.cluster + rank) * g.chunk
            for group in range(g.groups):
                for q0 in range(group, g.chunk, g.groups * _BATCH):
                    qq = q0 + g.groups * np.arange(_BATCH)
                    p = p0 + qq[qq < g.chunk]
                    count[p[p < T], :] += 1          # every slab's 128 lanes
    order = [p for k in range(g.rounds) for rr in range(g.cluster)
             for p in range((k * g.cluster + rr) * g.chunk,
                            min(T, (k * g.cluster + rr + 1) * g.chunk))]
    owned = LANE // g.cluster
    owners = np.zeros(LANE, np.int32)
    for rank in range(g.cluster):
        owners[rank * owned + np.arange(owned)] += 1
    return count, order, owners


@dataclasses.dataclass(frozen=True)
class GsGeometry:
    """One K5 launch: one cluster of ``GS_CLUSTER`` blocks of ``groups``
    x 128 threads walking ``tiles`` tiles, each tile's passes cut into
    chunks of ``chunk`` streamed through a ring of ``stages``; x in shared
    memory when ``x_shared``."""
    tiles: int
    groups: int
    chunk: int
    stages: int
    x_shared: bool
    passes: int             # the plan's T (its bases are staged too)

    @property
    def smem(self):
        return (self.tiles * GS_TILE * 4 if self.x_shared else 0) + \
            self.stages * self.chunk * LANE * 8 + self.passes * 4


@functools.lru_cache(maxsize=None)
def gs_geometry(T, rows):
    """K5's launch for a square plan of ``T`` passes and ``rows`` padded
    rows (``Sy * 128``, whole tiles): up to 8 pass-groups, and a tile's
    passes in one chunk where two stages of it fit (each chunk costs two
    block barriers and a residual chain).  x stays in shared memory when
    it fits beside two such stages, else in device memory."""
    tiles = -(-rows // GS_TILE)
    groups = _pow2_floor(min(T, 8))
    stage1 = groups * LANE * 8               # a stage's bytes per unit of per
    fixed = MAX_SMEM - K5_STATIC_SMEM - T * 4
    per = min(-(-T // groups), K5_MAX_CHUNK // groups)
    x_shared = fixed - tiles * GS_TILE * 4 >= 2 * per * stage1
    room = fixed - (tiles * GS_TILE * 4 if x_shared else 0)
    per = min(per, room // (2 * stage1))     # a deep plan: several chunks
    stages = min(K5_MAX_STAGES, room // (per * stage1))
    return GsGeometry(tiles, groups, groups * per, stages, x_shared, T)


def gs_schedule(g, T, reverse=False):
    """Replay K5's index arithmetic: ``(tiles, count, order)``, the tiles
    in visiting order, ``count[p, l]`` how often the product of pass p and
    row l of a tile is computed, and ``order`` the passes in the order a
    row's owner subtracts them."""
    per = g.chunk // g.groups
    count = np.zeros((T, GS_TILE), np.int32)
    order = []
    for ch in range(-(-T // g.chunk)):
        p0 = ch * g.chunk
        cnt = min(g.chunk, T - p0)
        for rank in range(GS_CLUSTER):
            for group in range(g.groups):
                q = group * per + np.arange(per)
                p = p0 + q[q < cnt]
                count[p, rank * LANE:(rank + 1) * LANE] += 1
        order.extend(range(p0, p0 + cnt))
    tiles = list(range(g.tiles))
    return (tiles[::-1] if reverse else tiles), count, order


def _check_plan(A, x):
    """Validate the operands of both kernels (on every device, so the CPU
    tests reach the same checks)."""
    if not isinstance(A, SELL) or A.bases_t is None:
        raise TypeError("the SELL kernels take a SELL placed with .to()")
    if A.vals.dtype != torch.float32 or A.delta.dtype != torch.int32:
        raise TypeError("a SELL plan is float32 values and int32 deltas")
    if A.vals.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {A.vals.device}")
    if not (A.vals.is_contiguous() and A.delta.is_contiguous()):
        raise ValueError("a SELL plan's arrays must be contiguous")
    if A.vals.data_ptr() % 16 or A.delta.data_ptr() % 16:
        raise ValueError("a SELL plan's arrays must be 16-byte aligned "
                         "(K5 copies them in 16-byte pieces)")
    check_vector("x", x, (A.shape[1],), torch.float32, A.vals.device)


def _gather(A, x, lo=0, hi=None):
    """(values, x at the column of every slot) of rows [lo, hi): two
    (T, hi - lo) tensors; a column outside [0, len(x)) reads 0."""
    T, Sy, _ = A.vals.shape
    hi = A.shape[0] if hi is None else hi
    dev = A.vals.device
    sigma = torch.arange(lo, hi, device=dev) // LANE
    anchor = sigma // A.t if A.kind == "tall" else sigma * A.t
    bases = A.bases_t.long()
    delta = A.delta.reshape(T, Sy * LANE)[:, lo:hi]
    cols = LANE * (anchor[None, :] + bases[:, None]) + delta
    m = x.shape[0]
    ok = (cols >= 0) & (cols < m)
    xg = torch.where(ok, x[cols.clamp(0, m - 1)], 0.0)
    return A.vals.reshape(T, Sy * LANE)[:, lo:hi], xg


# ---------------------------------------------------------------------------
# K3/K4: SELL SpMV
# ---------------------------------------------------------------------------

def sell_spmv_plain(A, x):
    """Plain version of K3/K4: gather every slot's x, then sum the passes'
    products in pass order."""
    vals, xg = _gather(A, x)
    y = vals[0] * xg[0]
    for p in range(1, vals.shape[0]):
        y = y + vals[p] * xg[p]
    return y


def sell_spmv(A, x):
    """y = A @ x for a SELL operator placed on x's device (K3/K4 on CUDA
    tensors, the plain version on CPU tensors)."""
    _check_plan(A, x)
    if x.device.type == "cpu":
        return sell_spmv_plain(A, x)
    n, m = A.shape
    T, Sy, _ = A.vals.shape
    g = spmv_geometry(T, n)
    y = torch.empty((n,), dtype=torch.float32, device=x.device)
    rc = launch.library("sell_kernels", ENTRY_POINTS).pyamg_sell_spmv_f32(
        A.vals.data_ptr(), A.delta.data_ptr(), A.bases_t.data_ptr(), T,
        Sy * LANE, n, m, A.t, int(A.kind == "fat"), int(A.zero_delta0),
        x.data_ptr(), y.data_ptr(), g.slabs, g.groups, g.cluster, g.chunk,
        g.rounds, g.buffers, g.smem, launch.stream(x.device))
    launch.check_rc(rc, "sell_spmv")
    launch.launched(sell_spmv, plan_key(A))
    return y


launch.countable(sell_spmv)


# ---------------------------------------------------------------------------
# K5: hybrid Gauss-Seidel sweep
# ---------------------------------------------------------------------------

def _padded(v, rows):
    return torch.nn.functional.pad(v, (0, rows - v.shape[0]))


def sell_gs_sweep_plain(A, x, b, Dinv, omega=1.0, sweep="forward"):
    """Plain version of K5: the tiles in sweep order, each updated from
    the x at tile entry, the residual taken pass by pass.

    As the reference, each direction sweeps all ``Sy * 128`` rows of the
    plan over an x padded with zeros (b and Dinv too) and reads a column
    past them as 0: a padded row stays 0 unless its slots reach a
    non-finite x, and is then read as NaN by later tiles."""
    n = A.shape[0]
    rows = A.Sy * LANE
    b, Dinv = _padded(b, rows), _padded(Dinv, rows)
    for reverse in _SWEEPS[sweep]:
        x = _padded(x[:n], rows)
        ntiles = rows // GS_TILE
        for k in range(ntiles):
            tile = ntiles - 1 - k if reverse else k
            lo, hi = tile * GS_TILE, (tile + 1) * GS_TILE
            vals, xg = _gather(A, x, lo, hi)
            r = b[lo:hi]
            for p in range(vals.shape[0]):
                r = r - vals[p] * xg[p]
            x[lo:hi] = x[lo:hi] + omega * Dinv[lo:hi] * r
    return x[:n]


def sell_gs_sweep(A, x, b, Dinv, omega=1.0, sweep="forward"):
    """One ``sweep`` ('forward', 'backward' or 'symmetric') of hybrid
    Gauss-Seidel on a square SELL placed on x's device; returns the new x
    (K5 on CUDA tensors, the plain version on CPU tensors)."""
    if not A.square:
        raise ValueError("Gauss-Seidel needs a square SELL")
    if sweep not in _SWEEPS:
        raise ValueError(f"unknown sweep {sweep!r}")
    _check_plan(A, x)
    check_vector("b", b, (A.shape[0],), torch.float32, x.device)
    check_vector("Dinv", Dinv, (A.shape[0],), torch.float32, x.device)
    if x.device.type == "cpu":
        return sell_gs_sweep_plain(A, x, b, Dinv, omega, sweep)
    T, Sy, _ = A.vals.shape
    g = gs_geometry(T, Sy * LANE)
    out = _padded(x, Sy * LANE)      # the kernel zeroes the padded rows
    fn = launch.library("sell_kernels", ENTRY_POINTS).pyamg_sell_gs_sweep_f32
    stream = launch.stream(x.device)
    for reverse in _SWEEPS[sweep]:
        rc = fn(A.vals.data_ptr(), A.delta.data_ptr(), A.bases_t.data_ptr(),
                T, Sy * LANE, A.shape[0], b.data_ptr(), Dinv.data_ptr(),
                float(omega), reverse, out.data_ptr(), g.tiles, g.groups,
                g.chunk, g.stages, int(g.x_shared), g.smem, stream)
        launch.check_rc(rc, "sell_gs_sweep")
        launch.launched(sell_gs_sweep, plan_key(A))  # one a direction
    return out[:A.shape[0]]


launch.countable(sell_gs_sweep)

KERNELS = (sell_spmv, sell_gs_sweep)
