"""The distributed setup: an SA or classical hierarchy built rank by rank,
with no global matrix on any host (counterpart of
``pyamg_tpu/parallel/dist_setup.py``).

Each level's operator is split into row blocks of ``n_loc`` rows with
*global* column indices.  Every access across ranks is a ghost-margin
exchange: a rank receives the last ``g`` rows of the ranks before it and
the first ``g`` rows of the ranks after it (a ring that does not wrap; the
ends receive zeros), which gives it the extended block
``[prev_g | local | next_g]``.  Aggregation (Luby MIS-2 and label
propagation) runs on the global strength graph through the same margins,
each rank owns ``c_cap`` coarse ids, P is the Jacobi-smoothed tentative
prolongator, R = Pᵀ is a per-rank transpose of the extended P, and the
Galerkin product is a per-rank sparse product with sort-based coalescing
(``ops.rowops.dedup_rows``).

The JAX package writes each level as one ``shard_map`` body.  Here every
per-rank step is written once, over arrays whose leading axis holds the
ranks this process computes, and takes the exchange as an argument:

* a ``partition.RowMesh`` (one rank a process, ``torch.distributed``):
  the margins go to the ring neighbours by ``batch_isend_irecv``, integer
  sums and maxima are ``all_reduce``s, and a sum of floats is an
  all-gather of the ranks' partial sums followed by their sum in rank
  order, so that every rank adds in the same order as the one-process
  form below;
* a ``StackedMesh`` (every rank of the mesh in this process): the margins
  are windows of the zero-padded stacked rows and the sums are sums over
  the rank axis.  It checks the port against the JAX package's 8-device
  hierarchy in one process, and runs all ranks on one card.

The public arrays are the rows of the ranks this process computes, in
rank order: a ``StackedMesh`` holds the whole padded operator, a
``RowMesh`` one block.  The setup reads on the host once a level (the
margin, the spectral radius, the diagnostics) and once a Luby round.  The
first solve lays each level's A, P and R out for the CUDA kernel K6
(``ops/dist_kernels.py``), one read a level; after that the V-cycle reads
nothing, and each of its sparse products is one K6 launch.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from pyamg_tpu_torch import _graph, _trace
from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.ops.dist_kernels import dist_slice_apply, slice_layouts
from pyamg_tpu_torch.ops.rowops import dedup_rows
from pyamg_tpu_torch.parallel.partition import RowMesh, count


# --------------------------------------------------------------------------
# the exchange over the ranks
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StackedMesh:
    """Every one of ``size`` ranks of a row mesh in this process, on
    ``device`` (default the card, as ``make_row_mesh``'s)."""

    size: int
    device: torch.device = None

    def __post_init__(self):
        object.__setattr__(self, "size", int(self.size))
        object.__setattr__(self, "device", resolve(
            "cuda" if self.device is None else self.device))


class _Exchange:
    """What a per-rank body needs of the mesh: ``ndev`` ranks in all, the
    ``ranks`` this process computes (a (R,) tensor), margins and sums.
    ``direct``: every margin of every local rank is rows this process
    holds (all ranks in it, or one rank in all), so a product may read the
    local rows themselves in place of each rank's extended block."""

    ndev: int
    ranks: torch.Tensor
    device: torch.device
    direct: bool

    @property
    def R(self):
        return int(self.ranks.shape[0])

    def row0(self, n_loc):
        """(R,) global index of each local rank's first row."""
        return self.ranks * n_loc

    def vdot(self, u, v):
        """(1, 1): the sum over all ranks of <u, v> (u, v of (R, n))."""
        return self.psum(torch.sum(u * v, dim=-1))[:, None]


class _Stacked(_Exchange):
    def __init__(self, mesh: StackedMesh):
        self.ndev = mesh.size
        self.device = mesh.device
        self.ranks = torch.arange(mesh.size, device=mesh.device)
        self.direct = True

    def ext_rows(self, x, g):
        """[previous ranks' last g rows | x | next ranks' first g rows] of
        every rank: windows of the stacked rows padded with g zero rows."""
        if g == 0:
            return x
        R, n = x.shape[:2]
        z = x.new_zeros((g,) + tuple(x.shape[2:]))
        flat = torch.cat([z, x.reshape((R * n,) + tuple(x.shape[2:])), z])
        idx = (self.ranks * n)[:, None] + torch.arange(
            n + 2 * g, device=x.device)[None, :]
        return flat[idx]

    def psum(self, t):
        return torch.sum(t, dim=0, keepdim=True)

    def pmax(self, t):
        return torch.amax(t, dim=0, keepdim=True)

    def gather_rows(self, x):
        return x.reshape((-1,) + tuple(x.shape[2:]))


class _Ring(_Exchange):
    def __init__(self, mesh: RowMesh):
        self.mesh = mesh
        self.ndev = mesh.size
        self.device = mesh.device
        self.ranks = torch.tensor([mesh.rank], device=mesh.device)
        self.direct = self.ndev == 1

    def _shift(self, blocks):
        """One hop: ``blocks[0]`` goes to the next rank and ``blocks[1]``
        to the previous one; returns (from the previous rank, from the
        next rank), zeros at the ends of the ring."""
        m = self.mesh
        r, p = m.rank, m.size
        up, down = blocks
        from_prev, from_next = torch.zeros_like(up), torch.zeros_like(down)
        ops = []
        if r + 1 < p:
            ops += [dist.P2POp(dist.isend, up, m.ranks[r + 1], m.group),
                    dist.P2POp(dist.irecv, from_next, m.ranks[r + 1],
                               m.group)]
        if r > 0:
            ops += [dist.P2POp(dist.isend, down, m.ranks[r - 1], m.group),
                    dist.P2POp(dist.irecv, from_prev, m.ranks[r - 1],
                               m.group)]
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            count("send", len(ops) // 2)
            count("recv", len(ops) // 2)
        return from_prev, from_next

    def ext_rows(self, x, g):
        """The ring exchange of ``_ext_rows`` (``dist_setup.py:62``): hop k
        relays the last (first) min(n_loc, g - (k-1) n_loc) rows of the
        block k ranks back (ahead)."""
        if g == 0:
            return x
        if self.ndev == 1:
            z = x.new_zeros((1, g) + tuple(x.shape[2:]))
            return torch.cat([z, x, z], dim=1)
        isbool = x.dtype == torch.bool
        v = x[0].to(torch.uint8) if isbool else x[0]
        n = v.shape[0]
        hops = -(-g // n)
        cur_p, cur_n = v, v
        prev, nxt = [], []
        for k in range(hops):
            m = min(n, g - k * n)
            cur_p, cur_n = self._shift((cur_p[-m:].contiguous(),
                                        cur_n[:m].contiguous()))
            prev.insert(0, cur_p)
            nxt.append(cur_n)
        out = torch.cat(prev + [v] + nxt)[None]
        return out.bool() if isbool else out

    def _gather(self, t):
        t = t.contiguous()
        out = t.new_empty((self.ndev,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.mesh.group)
        count("all_gather")
        return out

    def _reduce(self, t, op):
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.mesh.group)
        count("all_reduce")
        return t

    def psum(self, t):
        if t.is_floating_point() or t.is_complex():
            return torch.sum(self._gather(t), dim=0, keepdim=True)
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t):
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather_rows(self, x):
        isbool = x.dtype == torch.bool
        out = self._gather(x.to(torch.uint8) if isbool else x)
        out = out.reshape((-1,) + tuple(x.shape[2:]))
        return out.bool() if isbool else out


def exchange_of(mesh) -> _Exchange:
    """The exchange of a ``RowMesh`` (one rank a process) or a
    ``StackedMesh`` (every rank in this process)."""
    if isinstance(mesh, StackedMesh):
        return _Stacked(mesh)
    if isinstance(mesh, RowMesh):
        return _Ring(mesh)
    raise TypeError(f"a row mesh is a RowMesh or a StackedMesh, not "
                    f"{type(mesh).__name__}")


def _local_ranks(mesh):
    return list(range(mesh.size)) if isinstance(mesh, StackedMesh) \
        else [mesh.rank]


# --------------------------------------------------------------------------
# per-rank primitives: arrays carry the local ranks on their leading axis
# --------------------------------------------------------------------------

def _flat_take(x_ext, idx):
    """x_ext[r, idx[r, ...]] for each local rank r (idx in range)."""
    R, ne = x_ext.shape[:2]
    off = (torch.arange(R, device=idx.device) * ne).view(
        (R,) + (1,) * (idx.ndim - 1))
    return x_ext.reshape((R * ne,) + tuple(x_ext.shape[2:]))[idx + off]


def _gather_ext(x_ext, cols_g, base, valid):
    """out[r, i, k] = x_ext[r, cols_g[r, i, k] - base[r]] where valid and in
    range, else 0; and that mask."""
    ne = x_ext.shape[1]
    idx = cols_g - base.view((-1,) + (1,) * (cols_g.ndim - 1))
    ok = valid & (idx >= 0) & (idx < ne)
    out = _flat_take(x_ext, torch.clamp(idx, 0, ne - 1))
    okb = ok.view(ok.shape + (1,) * (out.ndim - ok.ndim))
    return torch.where(okb, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device)), ok


def _spmv_shard(vals, cols_g, valid, x_ext, base):
    g, _ = _gather_ext(x_ext, cols_g, base, valid)
    return torch.sum(torch.where(valid, vals, 0) * g, dim=-1)


def _per_rank(t):
    """(R,) sum of each local rank's entries."""
    return torch.sum(t.reshape(t.shape[0], -1).to(torch.int64), dim=1)


def _truncate_by_mag(cols, vals, okmask, out_width):
    """Keep each row's ``out_width`` largest-|value| entries, sorted by
    column, and the (R,) count dropped on each rank."""
    W = cols.shape[-1]
    R = cols.shape[0]
    if W <= out_width:
        pad = out_width - W
        if pad:
            cols = torch.nn.functional.pad(cols, (0, pad))
            vals = torch.nn.functional.pad(vals, (0, pad))
            okmask = torch.nn.functional.pad(okmask, (0, pad))
        return cols, vals, okmask, torch.zeros(R, dtype=torch.int64,
                                               device=cols.device)
    negabs = torch.where(okmask, -torch.abs(vals),
                         torch.ones((), dtype=vals.dtype, device=vals.device))
    order = torch.sort(negabs, dim=-1, stable=True).indices
    c2 = torch.gather(cols, -1, order)
    v2 = torch.gather(vals, -1, order)
    ok2 = torch.gather(okmask, -1, order)
    dropped = _per_rank(ok2[..., out_width:])
    c2, v2, ok2 = (a[..., :out_width] for a in (c2, v2, ok2))
    key = torch.where(ok2, c2, 2 ** 31 - 1)
    order = torch.sort(key, dim=-1, stable=True).indices
    c3 = torch.gather(c2, -1, order)
    v3 = torch.gather(v2, -1, order)
    ok3 = torch.gather(ok2, -1, order)
    return c3, torch.where(ok3, v3, 0), ok3, dropped


def _spgemm_shard(a_cols, a_vals, a_ok, b_cols_ext, b_vals_ext, b_ok_ext,
                  base, n_cols_out, out_width, chunk=8):
    """C = A @ B_ext on each rank with global output columns, over A's
    slots in chunks of ``chunk``; rows past ``out_width`` keep their
    largest-|value| entries, and the (R,) running maximum of the drops is
    returned."""
    R, n, WA = a_cols.shape
    ne = b_cols_ext.shape[1]
    dev = a_cols.device
    acc_c = torch.zeros((R, n, out_width), dtype=torch.int64, device=dev)
    acc_v = torch.zeros((R, n, out_width), dtype=b_vals_ext.dtype,
                        device=dev)
    acc_ok = torch.zeros((R, n, out_width), dtype=torch.bool, device=dev)
    dropped = torch.zeros(R, dtype=torch.int64, device=dev)
    base = base.view(-1, 1)
    for j0 in range(0, WA, chunk):
        j1 = min(j0 + chunk, WA)
        parts_c, parts_v, parts_ok = [acc_c], [acc_v], [acc_ok]
        for j in range(j0, j1):
            idx = a_cols[:, :, j] - base
            ok_j = a_ok[:, :, j] & (idx >= 0) & (idx < ne)
            idxc = torch.clamp(idx, 0, ne - 1)
            parts_c.append(_flat_take(b_cols_ext, idxc))
            parts_v.append(a_vals[:, :, j:j + 1] * _flat_take(b_vals_ext,
                                                              idxc))
            parts_ok.append(ok_j[..., None] & _flat_take(b_ok_ext, idxc))
        cc = torch.cat(parts_c, dim=-1)
        vv = torch.cat(parts_v, dim=-1)
        ok = torch.cat(parts_ok, dim=-1)
        c, v, rn = dedup_rows(cc, vv, ok, n_cols_out)
        keep = torch.arange(c.shape[-1], device=dev) < rn[..., None]
        acc_c, acc_v, acc_ok, dr = _truncate_by_mag(c, v, keep, out_width)
        dropped = torch.maximum(dropped, dr)
    return acc_c, acc_v, acc_ok, dropped


def _transpose_shard(p_cols_ext, p_vals_ext, p_ok_ext, col0, c_cap,
                     out_width):
    """R = P_extᵀ restricted to each rank's coarse columns
    [col0, col0 + c_cap), its columns the extended fine rows.  Sorted by
    (local coarse id, -|value|), stable: two stable sorts, the minor key
    first; the entries past ``out_width`` in a row are dropped and
    counted."""
    R, ne, WP = p_cols_ext.shape
    dev = p_cols_ext.device
    c_loc = p_cols_ext - col0.view(-1, 1, 1)
    ok = p_ok_ext & (c_loc >= 0) & (c_loc < c_cap)
    key = torch.where(ok, c_loc, c_cap).reshape(R, -1)
    vals = torch.where(ok, p_vals_ext, 0).reshape(R, -1)
    negabs = torch.where(ok, -torch.abs(p_vals_ext), torch.ones(
        (), dtype=p_vals_ext.dtype, device=dev)).reshape(R, -1)
    o1 = torch.sort(negabs, dim=-1, stable=True).indices
    key1 = torch.gather(key, -1, o1)
    key_s, o2 = torch.sort(key1, dim=-1, stable=True)
    perm = torch.gather(o1, -1, o2)
    iext_s = torch.div(perm, WP, rounding_mode="floor")
    vals_s = torch.gather(vals, -1, perm)
    L = key_s.shape[1]
    idx = torch.arange(L, device=dev).expand(R, L)
    head = torch.cat([torch.ones((R, 1), dtype=torch.bool, device=dev),
                      key_s[:, 1:] != key_s[:, :-1]], dim=1)
    run_start = torch.cummax(torch.where(head, idx, 0), dim=1).values
    rank = idx - run_start
    live = key_s < c_cap
    keep = live & (rank < out_width)
    rk = torch.where(keep, rank, out_width)
    kk = torch.where(keep, key_s, c_cap)
    rr = torch.arange(R, device=dev)[:, None].expand(R, L)
    shape = (R, c_cap + 1, out_width + 1)
    r_cols = torch.zeros(shape, dtype=torch.int64, device=dev)
    r_vals = torch.zeros(shape, dtype=vals.dtype, device=dev)
    r_ok = torch.zeros(shape, dtype=torch.bool, device=dev)
    r_cols[rr, kk, rk] = iext_s
    r_vals[rr, kk, rk] = vals_s
    r_ok[rr, kk, rk] = keep
    dropped = _per_rank(live & (rank >= out_width))
    return (r_cols[:, :c_cap, :out_width], r_vals[:, :c_cap, :out_width],
            r_ok[:, :c_cap, :out_width], dropped)


_PROP_ROUNDS = 3      # label-propagation rounds; MIS-2 maximality puts
                      # every eligible node within 2 hops of a root, so 3
                      # rounds always label everything (radius bound 3)


def _transfer_margin(g: int, n_loc: int, ndev: int) -> int:
    """Ghost margin of the transfer operators: a root within _PROP_ROUNDS
    hops and one smoothing hop, each hop at most g rows."""
    return min((_PROP_ROUNDS + 1) * g, ndev * n_loc)


def mis_hash(rows_g, shift=1):
    """``(uint32(rows) * 2654435761) >> shift`` as a signed integer: the
    JAX package's uint32 product, computed in int64 and masked to 32 bits
    before the shift."""
    return ((rows_g.to(torch.int64) * 2654435761) & 0xFFFFFFFF) >> shift


def _read(t, kind=int):
    """``kind(t)``: one blocking host read of the set-up, counted
    (``dist_setup.host_reads``)."""
    _trace.count("dist_setup.host_reads")
    return kind(t)


def _nb_max_global(ex, cols_g, strong, x, row0, g, fill=-1):
    """The maximum over each node and its strong neighbours, across ranks,
    of integer per-node values."""
    x_ext = ex.ext_rows(x, g)
    gx, okg = _gather_ext(x_ext, cols_g, row0 - g, strong)
    return torch.maximum(x, torch.amax(torch.where(okg, gx, fill), dim=-1))


def _mis_global(ex, cols_g, strong, eligible, rows_g, row0, g, dist=2,
                max_rounds=24, weights=None):
    """Luby distance-``dist`` MIS on the global strength graph; the
    priorities default to ``mis_hash`` of the global rows.  One host read
    a round: the count of nodes still active, summed over the ranks (each
    round one span ``dist_setup.mis_round``, its read included).
    Returns the root mask."""
    w0 = mis_hash(rows_g) if weights is None else weights

    def nb_max_k(x):
        for _ in range(dist):
            x = _nb_max_global(ex, cols_g, strong, x, row0, g)
        return x

    active = eligible
    roots = torch.zeros_like(eligible)
    done = _read(ex.psum(_per_rank(eligible))[0]) == 0
    it = 0
    while not done and it < max_rounds:
        with _trace.span("dist_setup.mis_round", round=it):
            wa = torch.where(active, w0, -1)
            mk = nb_max_k(wa)
            roots = roots | (active & (wa == mk) & (wa >= 0))
            rk = nb_max_k(roots.to(torch.int64))
            active = active & (rk < 1)
            done = _read(ex.psum(_per_rank(active))[0]) == 0
        it += 1
    return roots


def _mis2_global(ex, cols_g, strong, eligible, rows_g, row0, g,
                 max_rounds=24):
    return _mis_global(ex, cols_g, strong, eligible, rows_g, row0, g,
                       dist=2, max_rounds=max_rounds)


def _propagate_global(ex, cols_g, strong, w, lab, eligible, row0, g,
                      rounds=6):
    """Label propagation across ranks: each round exchanges the labels'
    margins, and every unlabelled eligible node takes the label of its
    strongest labelled neighbour (the first of equal weights)."""
    for _ in range(rounds):
        lab_ext = ex.ext_rows(lab, g)
        labs, okg = _gather_ext(lab_ext, cols_g, row0 - g, strong)
        okl = okg & (torch.where(okg, labs, -1) >= 0)
        score = torch.where(okl, w, -torch.inf)
        j = torch.argmax(score, dim=-1, keepdim=True)
        best_ok = torch.gather(okl, -1, j)[..., 0]
        best = torch.gather(labs, -1, j)[..., 0]
        lab = torch.where((lab < 0) & eligible & best_ok, best, lab)
    return lab


# --------------------------------------------------------------------------
# containers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistLevel:
    """One level split by rows: the rows of this process's ranks, global
    columns (int32), ``n_loc`` rows a rank."""
    cols: torch.Tensor            # (R n_loc, W) int32, global columns
    vals: torch.Tensor            # (R n_loc, W)
    ok: torch.Tensor              # (R n_loc, W) bool
    n_loc: int                    # rows a rank
    g: int                        # ghost margin (rows) of this operator
    Dinv: torch.Tensor = None     # (R n_loc,) inverse diagonal
    p_cols: torch.Tensor = None   # (R n_loc, WP) global coarse columns
    p_vals: torch.Tensor = None
    p_ok: torch.Tensor = None
    r_cols: torch.Tensor = None   # (R c_cap, WR) extended fine rows
    r_vals: torch.Tensor = None
    r_ok: torch.Tensor = None
    omega: float = None           # damped-Jacobi weight (omega / rho)
    cheb: torch.Tensor = None     # Chebyshev coefficients (descending)
    gp: int = 0                   # transfer margin of R's columns
    gcp: int = 0                  # coarse-vector margin of the prolongation
    ndev: int = 1                 # ranks of the mesh
    mesh: object = None

    @property
    def n(self):
        """Rows of the whole (padded) level."""
        return self.n_loc * self.ndev

    def nnz(self):
        """Stored entries over every rank (one host read)."""
        ex = exchange_of(self.mesh)
        return int(ex.psum(_per_rank(self.ok.view(ex.R, self.n_loc, -1)))[0])


def _lu_solve(A, b):
    """x of the small square system A x = b: LU with partial pivoting
    (``lu_factor_ex``), then the row interchanges and the two triangular
    solves written out, as LAPACK's ``getrs`` does them.  cuSOLVER's
    ``getrs`` (what ``torch.linalg.solve`` runs) may allocate device
    memory inside a CUDA-graph capture, and a conditional node's body
    holds no allocation."""
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    piv = piv.long() - 1
    perm = torch.arange(A.shape[0], device=A.device)
    for i in range(A.shape[0]):
        p = piv[i:i + 1]
        here = perm[i:i + 1].clone()
        perm[i:i + 1] = perm.index_select(0, p)
        perm.index_copy_(0, p, here)
    y = torch.linalg.solve_triangular(LU, b[perm][:, None], upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(LU, y, upper=True)[:, 0]


def _entries(ex, cols, vals, ok, rows, n_src, g, ext=False):
    """(index, value, kept, source length) of an operator's (R rows, W)
    entries for K6, read from a vector of ``n_src`` rows a rank with
    margin ``g``: ``cols`` global rows of that vector, or with ``ext``
    places in each rank's extended block.  Kept where stored and inside
    the block and the vector, as ``_gather_ext`` reads them; the index is
    the global row where the exchange is ``direct`` (the vector's own
    rows), else the place in the stacked extended blocks."""
    R, ne = ex.R, n_src + 2 * g
    base = (ex.ranks * n_src - g).view(-1, 1, 1)
    e = cols.to(torch.int64).view(R, rows, -1)
    if not ext:
        e = e - base
    glob = e + base
    keep = ok.view(R, rows, -1) & (e >= 0) & (e < ne) & (glob >= 0) & \
        (glob < ex.ndev * n_src)
    if ex.direct:
        idx, length = glob, ex.ndev * n_src
    else:
        idx, length = e + (torch.arange(R, device=e.device) * ne).view(
            -1, 1, 1), R * ne
    W = e.shape[-1]
    return (idx.reshape(-1, W), vals.reshape(-1, W), keep.reshape(-1, W),
            length)


class _Slices:
    """One level of the solve phase as K6 products
    (``ops/dist_kernels.py``): A (margin ``g``), and above the coarsest
    level P (coarse vector, margin ``gc``) and R (the residual, margin
    ``gp``); ``w`` = omega D⁻¹ of the Jacobi sweep.  Vectors are (R, rows)
    blocks; each product is one launch on a card."""

    def __init__(self, L, A, P=None, R=None, gc=0):
        self.A, self.P, self.R = A, P, R
        self.g, self.gp, self.gc = L.g, L.gp, gc
        self.cheb = L.cheb
        self.w = L.omega * L.Dinv

    @staticmethod
    def _source(ex, v, g):
        """The vector a product reads for the (R, rows) blocks ``v``."""
        return (v if ex.direct else ex.ext_rows(v, g)).reshape(-1)

    def _run(self, ex, op, v, g, mode, x=None, b=None, w=None):
        flat = [None if t is None else t.reshape(-1) for t in (x, b)]
        y = dist_slice_apply(op, self._source(ex, v, g), mode, *flat, w=w)
        return y.view(ex.R, -1)

    def apply(self, ex, v):
        return self._run(ex, self.A, v, self.g, "apply")

    def residual(self, ex, x, b):
        return self._run(ex, self.A, x, self.g, "residual", b=b)

    def jacobi(self, ex, x, b):
        """One damped-Jacobi sweep, x + omega D⁻¹ (b - A x), into a new
        tensor; from x = 0 where ``x`` is None (no product: A 0 is 0)."""
        if x is None:
            y = dist_slice_apply(self.A, None, "jacobi0", b=b.reshape(-1),
                                 w=self.w)
            return y.view(ex.R, -1)
        return self._run(ex, self.A, x, self.g, "jacobi", x, b, self.w)

    def restrict(self, ex, r):
        return self._run(ex, self.R, r, self.gp, "apply")

    def correct(self, ex, x, xc):
        """x + P xc."""
        return self._run(ex, self.P, xc, self.gc, "correct", x)


def _solve_slices(ex, levels):
    """Each level's ``_Slices`` but the coarsest's (solved densely; level 0
    always, for the Krylov loops' A x), built on the levels' device with
    one host read a level (``_read``: the layouts' sizes)."""
    out = []
    for i, L in enumerate(levels[:max(len(levels) - 1, 1)]):
        n = L.n_loc
        ops = [_entries(ex, L.cols, L.vals, L.ok, n, n, L.g)]
        gc = 0
        if L.p_cols is not None:
            nc = levels[i + 1].n_loc
            gc = max(levels[i + 1].g, L.gcp)
            ops += [_entries(ex, L.p_cols, L.p_vals, L.p_ok, n, nc, gc),
                    _entries(ex, L.r_cols, L.r_vals, L.r_ok, nc, n, L.gp,
                             ext=True)]
        layouts = slice_layouts(ops, lambda t: _read(t, torch.Tensor.tolist))
        out.append(_Slices(L, *layouts, gc=gc))
    return out


@dataclasses.dataclass
class DistHierarchy:
    levels: List[DistLevel]
    mesh: object
    coarse_dense: torch.Tensor          # whole dense pinv of the coarsest
    coarse_n: int
    diagnostics: dict

    def operator_complexity(self):
        fine = self.levels[0].nnz()
        return sum(l.nnz() for l in self.levels) / max(fine, 1)

    # ---------------- solve phase ----------------
    def _slices(self, ex):
        """The levels' solve layouts (``_solve_slices``), built at the
        first solve and kept: every later solve and program reuses them."""
        levs = self.__dict__.get("_solve_layout")
        if levs is None:
            levs = self._solve_layout = _solve_slices(ex, self.levels)
        return levs

    def _vcycle_shard(self, ex, levs, x, b, nu=2):
        """V(nu, nu) cycle over (R, n_loc) blocks from x (None: from 0);
        ``levs`` from ``_slices``: every sparse product one K6 launch, with
        the sweep, the residual and the correction fused into it, and each
        level's first sweep from 0 without its product.  Reads nothing on
        the host."""
        last = len(self.levels) - 1

        def smooth(S, x, b):
            if S.cheb is None:
                for _ in range(nu):
                    x = S.jacobi(ex, x, b)
                return torch.zeros_like(b) if x is None else x
            if x is None:
                x = torch.zeros_like(b)
            # x += p(A)(b - A x) by Horner (reference smoothing.py:627)
            co = S.cheb
            r = S.residual(ex, x, b)
            h = co[0] * r
            for i in range(1, co.shape[0]):
                h = co[i] * r + S.apply(ex, h)
            return x + h

        def cycle(l, x, b):
            if l == last:
                # the whole dense coarse solve on every rank
                xg = self.coarse_dense @ ex.gather_rows(b)
                return xg.view(ex.ndev, -1)[ex.ranks]
            S = levs[l]
            x = smooth(S, x, b)
            bc = S.restrict(ex, S.residual(ex, x, b))
            xc = cycle(l + 1, None, bc)
            return smooth(S, S.correct(ex, x, xc), b)

        return cycle(0, x, b)

    def _local(self, ex, b):
        """b as (R, n_loc) blocks: the rows of this process's ranks, or the
        whole padded vector."""
        n_loc = self.levels[0].n_loc
        dtype = self.levels[0].vals.dtype
        if not isinstance(b, torch.Tensor):
            b = torch.as_tensor(np.asarray(b))
        b = b.to(device=ex.device, dtype=dtype).reshape(-1)
        if b.shape[0] == ex.ndev * n_loc and ex.R != ex.ndev:
            b = b.view(ex.ndev, n_loc)[ex.ranks]
        return b.reshape(ex.R, n_loc)

    def _put_b(self, prog, ex, b):
        """b into the program (span ``solve.b_in``)."""
        with _trace.span("solve.b_in"):
            _trace.count_in(b)
            prog.put("b", self._local(ex, b))

    def _operators(self, ex, nu):
        levs = self._slices(ex)

        def Amv(x):
            return levs[0].apply(ex, x)

        def Mmv(r):
            return self._vcycle_shard(ex, levs, None, r, nu)

        return Amv, Mmv

    def _program(self, key, nu):
        """(program, (exchange, A x, V-cycle)) of the solve configuration
        ``key``: captured where the mesh's tensors live on a card (kept in
        the hierarchy's ``_graph.Cache`` with the exchange and the level
        views its graphs read), else a fresh eager one."""
        cache = self.__dict__.get("_graph_cache")
        if cache is None:
            cache = self._graph_cache = _graph.Cache()
        ex = exchange_of(self.mesh)
        prog = cache.program(key, ex.device)
        return prog, prog.static("operators", lambda: (
            ex,) + self._operators(ex, nu))

    def _result(self, prog, nodes, count):
        """Run the tree and read ``count`` and the relative residual once:
        ``(x, relres, count)``, x owned by the caller."""
        k, relres = prog.loop("solve", nodes, (count, "relres"))
        with _trace.span("solve.x_out"):
            x = prog.state["x"].reshape(-1)
            x = x.clone() if prog.captured else x
        return x, relres, k

    @_trace.entry
    def solve_cg(self, b, tol=1e-8, maxiter=100, nu=2):
        """V-cycle-preconditioned CG: ``(x, relres, iterations)``, x the
        rows of this process's ranks.  A tree of two steps, ``start`` and
        one iteration a trip while the residual norm, summed over all
        ranks (so every rank stops on the same iteration), is above ``tol``
        times that of b: one CUDA graph with one host read at its end
        where the mesh lives on a card (a ``StackedMesh`` there, or an
        NCCL ``RowMesh``), else op by op with one read an iteration."""
        prog, (ex, Amv, Mmv) = self._program(
            ("cg", float(tol), int(maxiter), int(nu)), nu)
        self._put_b(prog, ex, b)

        def go_on(r, bnorm):
            nr = torch.sqrt(ex.vdot(r, r))
            return {"relres": (nr / bnorm).reshape(()),
                    "stop": ~(nr > tol * bnorm).reshape(())}

        def start(s):
            b = s["b"]
            z = Mmv(b)
            bnorm = torch.sqrt(ex.vdot(b, b))
            return {"x": torch.zeros_like(b), "r": b, "z": z, "p": z,
                    "rz": ex.vdot(b, z), "bnorm": bnorm,
                    "it": torch.zeros((), dtype=torch.int32,
                                      device=b.device), **go_on(b, bnorm)}

        def iteration(s):
            x, r, p, rz = (s[k] for k in ("x", "r", "p", "rz"))
            Ap = Amv(p)
            alpha = rz / ex.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = Mmv(r)
            rz_new = ex.vdot(r, z)
            p = z + (rz_new / rz) * p
            return {"x": x, "r": r, "z": z, "p": p, "rz": rz_new,
                    "it": s["it"] + 1, **go_on(r, s["bnorm"])}

        nodes = [_graph.Step(prog, "start", start),
                 _graph.While(prog, [_graph.Step(prog, "iteration",
                                                 iteration)], maxiter)]
        return self._result(prog, nodes, "it")

    @_trace.entry
    def solve_fgmres(self, b, tol=1e-8, restart=20, max_outer=10, nu=2):
        """V-cycle-preconditioned FGMRES (right preconditioning):
        ``(x, relres, restart * cycles)``.  Arnoldi by classical
        Gram-Schmidt twice with summed dots; every rank solves the small
        least-squares problem (normal equations, ``_lu_solve``).  A tree of
        ``start`` and one restart cycle a trip (fixed width and masked, so
        each cycle is one step): one CUDA graph with one host read where
        the mesh lives on a card, else one read a cycle."""
        Rr = int(restart)
        prog, (ex, Amv, Mmv) = self._program(
            ("fgmres", float(tol), Rr, int(max_outer), int(nu)), nu)
        self._put_b(prog, ex, b)

        def vdots(V, w):
            """(1, Rr + 1): <V_k, w> summed over the ranks."""
            return ex.psum(torch.sum(V * w[:, None, :], dim=-1))

        def go_on(nr, bnorm):
            return {"relres": (nr / bnorm).reshape(()),
                    "stop": ~(nr > tol * bnorm).reshape(())}

        def start(s):
            b = s["b"]
            bnorm = torch.sqrt(ex.vdot(b, b))
            bnorm = torch.where(bnorm == 0, 1.0, bnorm)
            return {"x": torch.zeros_like(b), "bnorm": bnorm,
                    "k": torch.zeros((), dtype=torch.int32, device=b.device),
                    **go_on(torch.sqrt(ex.vdot(b, b)), bnorm)}

        def cycle(s):
            b, x = s["b"], s["x"]
            dt, dev = b.dtype, b.device
            R, n = b.shape
            eye = torch.eye(Rr, dtype=dt, device=dev)
            r = b - Amv(x)
            beta = torch.sqrt(ex.vdot(r, r))
            V = torch.zeros((R, Rr + 1, n), dtype=dt, device=dev)
            Z = torch.zeros((R, Rr, n), dtype=dt, device=dev)
            V[:, 0] = r / torch.where(beta == 0, 1, beta)
            H = torch.zeros((Rr + 1, Rr), dtype=dt, device=dev)
            for j in range(Rr):
                zj = Mmv(V[:, j])
                Z[:, j] = zj
                w = Amv(zj)
                mask = (torch.arange(Rr + 1, device=dev) <= j).to(dt)
                h1 = vdots(V, w) * mask
                w = w - torch.sum(V * h1[:, :, None], dim=1)
                h2 = vdots(V, w) * mask
                w = w - torch.sum(V * h2[:, :, None], dim=1)
                wn = torch.sqrt(ex.vdot(w, w))
                H[:, j] = (h1 + h2)[0]
                H[j + 1, j] = wn[0, 0]
                V[:, j + 1] = w / torch.where(wn == 0, 1, wn)
            e1 = torch.zeros((Rr + 1,), dtype=dt, device=dev)
            e1[0] = beta[0, 0]
            y = _lu_solve(H.T @ H + 1e-30 * eye, H.T @ e1)
            x = x + torch.sum(Z * y[None, :, None], dim=1)
            r = b - Amv(x)
            return {"x": x, "k": s["k"] + 1,
                    **go_on(torch.sqrt(ex.vdot(r, r)), s["bnorm"])}

        nodes = [_graph.Step(prog, "start", start),
                 _graph.While(prog, [_graph.Step(prog, "cycle", cycle)],
                              max_outer, count="k")]
        x, relres, k = self._result(prog, nodes, "k")
        return x, relres, k * Rr


# --------------------------------------------------------------------------
# the sharded gallery: each rank builds only its own rows
# --------------------------------------------------------------------------

def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def _np_dtype(dtype):
    return torch.empty((), dtype=_torch_dtype(dtype)).numpy().dtype


def _identity_pad(cols, vals, ok, r0, m):
    """Rows m.. of a rank's block (global rows past n) as identity rows."""
    n_loc = cols.shape[0]
    if m < n_loc:
        cols[m:, 0] = np.arange(r0 + m, r0 + n_loc)
        vals[m:, 0] = 1
        ok[m:, 0] = True


def _assemble(blocks, mesh, dtype):
    """(cols, vals, ok) of the local ranks' blocks, stacked in rank order,
    on the mesh's device (cols int32)."""
    dev = mesh.device
    cols = np.concatenate([b[0] for b in blocks])
    vals = np.concatenate([b[1] for b in blocks])
    ok = np.concatenate([b[2] for b in blocks])
    return (torch.as_tensor(cols.astype(np.int32), device=dev),
            torch.as_tensor(vals, device=dev).to(_torch_dtype(dtype)),
            torch.as_tensor(ok, device=dev))


def dist_stencil_grid(stencil, grid, mesh, dtype=torch.float32):
    """Row blocks of ``stencil_grid(stencil, grid)`` (Dirichlet
    truncation): each of this process's ranks builds only its own rows, the
    rows past n are identity rows.  Returns ``(cols, vals, ok, n_loc)``."""
    stencil = np.asarray(stencil)
    grid = tuple(int(g) for g in grid)
    n = int(np.prod(grid))
    ndev = int(mesh.size)
    n_loc = -(-n // ndev)
    n_pad = n_loc * ndev
    offs_nd = np.argwhere(np.ones(stencil.shape)) - \
        (np.asarray(stencil.shape) // 2)
    svals = stencil.ravel()
    keep = svals != 0
    offs_nd = offs_nd[keep]
    svals = svals[keep]
    strides = np.cumprod((grid[1:] + (1,))[::-1])[::-1]
    W = len(svals)
    npdt = _np_dtype(dtype)
    blocks = []
    for d in _local_ranks(mesh):
        r0, r1 = d * n_loc, min((d + 1) * n_loc, n)
        rows = np.arange(r0, max(r1, r0))
        idx = np.empty((len(rows), len(grid)), np.int64)
        rem = rows.copy()
        for axis, s in enumerate(strides):
            idx[:, axis] = rem // s
            rem = rem % s
        cols = np.zeros((n_loc, W), np.int64)
        vals = np.zeros((n_loc, W), npdt)
        ok = np.zeros((n_loc, W), bool)
        m = len(rows)
        for k, (off, sv) in enumerate(zip(offs_nd, svals)):
            tgt = idx + off[None, :]
            inside = np.all((tgt >= 0) & (tgt < np.asarray(grid)[None, :]),
                            axis=1)
            col = (tgt * strides[None, :]).sum(axis=1)
            cols[:m, k] = np.where(inside, col, 0)
            vals[:m, k] = np.where(inside, sv, 0)
            ok[:m, k] = inside
        _identity_pad(cols, vals, ok, r0, m)
        order = np.argsort(np.where(ok, cols, n_pad), axis=1)
        blocks.append(tuple(np.take_along_axis(a, order, axis=1)
                            for a in (cols, vals, ok)))
    return _assemble(blocks, mesh, dtype) + (n_loc,)


def dist_from_scipy(A, mesh, dtype=torch.float32, rcm=True):
    """Row blocks of a square sparse matrix (scipy or the port's ELL) for
    ``distributed_sa_setup``; ``rcm`` reorders it by reverse Cuthill-McKee
    first (the ghost margin is the bandwidth).  Returns ``(cols, vals, ok,
    n_loc, perm)``: ``perm`` maps the internal order to the original rows
    (``x_orig[perm] = x``)."""
    import scipy.sparse as sp
    from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
    if not sp.issparse(A):
        A = to_scipy(A)
    A = A.tocsr()
    n, m = A.shape
    if n != m:
        raise ValueError("expected square matrix")
    if rcm:
        from pyamg_tpu_torch.graph import symmetric_rcm
        perm = np.asarray(symmetric_rcm(from_scipy(A)))
        A = A[perm][:, perm].tocsr()
    else:
        perm = np.arange(n)
    ndev = int(mesh.size)
    n_loc = -(-n // ndev)
    W = int(np.diff(A.indptr).max()) if n else 1
    npdt = _np_dtype(dtype)
    blocks = []
    for d in _local_ranks(mesh):
        r0, r1 = d * n_loc, min((d + 1) * n_loc, n)
        cols = np.zeros((n_loc, W), np.int64)
        vals = np.zeros((n_loc, W), npdt)
        ok = np.zeros((n_loc, W), bool)
        for i, row in enumerate(range(r0, r1)):
            lo, hi = A.indptr[row], A.indptr[row + 1]
            k = hi - lo
            cols[i, :k] = A.indices[lo:hi]
            vals[i, :k] = A.data[lo:hi]
            ok[i, :k] = True
        _identity_pad(cols, vals, ok, r0, max(r1 - r0, 0))
        blocks.append((cols, vals, ok))
    return _assemble(blocks, mesh, dtype) + (n_loc, perm)


# --------------------------------------------------------------------------
# the setup driver
# --------------------------------------------------------------------------

def _blocks(ex, n_loc, *arrays):
    return [a.view((ex.R, n_loc) + tuple(a.shape[1:])) for a in arrays]


def _flat(*arrays):
    return [a.reshape((-1,) + tuple(a.shape[2:])) for a in arrays]


def _margin_of(ex, cols, ok, n_loc):
    """The smallest ghost margin that covers every coupling (one host
    read)."""
    cols, ok = _blocks(ex, n_loc, cols, ok)
    rows = ex.row0(n_loc)[:, None] + torch.arange(n_loc, device=ex.device)
    d = torch.where(ok, torch.abs(cols.to(torch.int64) - rows[..., None]), 0)
    return _read(ex.pmax(torch.amax(d.reshape(ex.R, -1), dim=1))[0])


def _diag_dinv(cols, vals, ok, rows_g):
    hit = ok & (cols == rows_g[..., None])
    diag = torch.sum(torch.where(hit, vals, 0), dim=-1)
    one = torch.ones((), dtype=diag.dtype, device=diag.device)
    dinv = torch.where(diag != 0, one / torch.where(diag != 0, diag, one),
                       0)
    return hit, diag, dinv


def _dinv_sharded(ex, cols, vals, ok, n_loc):
    cols, vals, ok = _blocks(ex, n_loc, cols, vals, ok)
    rows = ex.row0(n_loc)[:, None] + torch.arange(n_loc, device=ex.device)
    return _diag_dinv(cols.to(torch.int64), vals, ok, rows)[2].reshape(-1)


def random_start(seed, rank, n_loc):
    """The default start of the power iteration on ``rank``: normal draws
    of a CPU ``torch.Generator`` seeded from (seed, rank), the same on any
    device and in either form of the mesh."""
    gen = torch.Generator().manual_seed(int(seed) * 1000003 + int(rank))
    return torch.randn(n_loc, generator=gen, dtype=torch.float64)


def hashed_start(seed, rank, n_loc):
    """A start of the power iteration that a function of the global rows
    fixes: a hash of (seed, row) scaled to [-0.5, 0.5), exact in 64-bit
    integers (``tests/jax_dist_setup_reference.py`` gives the JAX package
    the same, so that both start from one vector)."""
    rows = int(rank) * n_loc + torch.arange(n_loc, dtype=torch.int64)
    h = ((rows + 1) * 2654435761 + (int(seed) + 1) * 2246822519) & \
        0xFFFFFFFF
    return h.to(torch.float64) / 4294967296.0 - 0.5


def _power_rho(ex, cols, vals, ok, n_loc, g, iters=8, seed=0, use_dinv=True,
               start=None):
    """rho(D⁻¹ A) (or rho(A) with ``use_dinv=False``) by normalised power
    iteration across the ranks, from ``start(seed, rank, n_loc)`` on each
    rank (default ``random_start``).  Two host reads: the ranks and rho."""
    start = random_start if start is None else start
    dt = vals.dtype
    if use_dinv:
        dinv = _dinv_sharded(ex, cols, vals, ok, n_loc).view(ex.R, n_loc)
    else:
        dinv = torch.ones((ex.R, n_loc), dtype=dt, device=ex.device)
    cols, vals, ok = _blocks(ex, n_loc, cols, vals, ok)
    cols = cols.to(torch.int64)
    base = ex.row0(n_loc) - g
    x = torch.stack([as_tensor(start(seed, r, n_loc), ex.device, dt)
                     for r in _read(ex.ranks, torch.Tensor.tolist)])
    x = x / torch.sqrt(ex.vdot(x, x))
    lam = torch.ones((1, 1), dtype=dt, device=ex.device)
    for _ in range(iters):
        y = dinv * _spmv_shard(vals, cols, ok, ex.ext_rows(x, g), base)
        nrm = torch.sqrt(ex.vdot(y, y))
        lam = nrm / torch.clamp(torch.sqrt(ex.vdot(x, x)), min=1e-30)
        x = y / torch.clamp(nrm, min=1e-30)
    return _read(lam, float)


def _identity_fill(ac_c, ac_v, ac_ok, used, own):
    """Unused coarse slots as identity rows (keeps smoothers defined)."""
    c_id = torch.zeros_like(ac_c)
    c_id[..., 0] = own
    v_id = torch.zeros_like(ac_v)
    v_id[..., 0] = 1
    ok_id = torch.zeros_like(ac_ok)
    ok_id[..., 0] = True
    u = used[..., None]
    return (torch.where(u, ac_c, c_id), torch.where(u, ac_v, v_id),
            torch.where(u, ac_ok, ok_id))


def _galerkin(ex, cols_b, vals_b, ok_b, p_cols, p_vals, p_ok, row0, gP,
              col0, c_cap, wr_eff, wac_eff):
    """AP = A P_ext, R = P_extᵀ on each rank's coarse block, Ac = R AP_ext;
    with the drops of each product."""
    n_out = ex.ndev * c_cap
    p_cols_ext = ex.ext_rows(p_cols, gP)
    p_vals_ext = ex.ext_rows(p_vals, gP)
    p_ok_ext = ex.ext_rows(p_ok, gP)
    ap_c, ap_v, ap_ok, dropped_ap = _spgemm_shard(
        cols_b, vals_b, ok_b, p_cols_ext, p_vals_ext, p_ok_ext, row0 - gP,
        n_out, wac_eff)
    r_cols, r_vals, r_ok, dropped_r = _transpose_shard(
        p_cols_ext, p_vals_ext, p_ok_ext, col0, c_cap, wr_eff)
    del p_cols_ext, p_vals_ext, p_ok_ext
    ac_c, ac_v, ac_ok, dropped_ac = _spgemm_shard(
        r_cols, r_vals, r_ok, ex.ext_rows(ap_c, gP), ex.ext_rows(ap_v, gP),
        ex.ext_rows(ap_ok, gP), torch.zeros_like(col0), n_out, wac_eff)
    return (r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok,
            dropped_ap + dropped_r + dropped_ac)


def _level_step(ex, cols, vals, ok, n_loc, g, c_cap, theta, omega_eff,
                wp_cap, wr_cap, wac_cap):
    """One SA level on every local rank: strength, aggregation across
    ranks, T, P = (I - omega D⁻¹ A) T, AP, R = Pᵀ and Ac
    (``dist_setup.py:1142``).  Arrays are (R, n_loc, W)."""
    ndev = ex.ndev
    gP = _transfer_margin(g, n_loc, ndev)
    W_in = int(cols.shape[-1])
    wp_eff = max(wp_cap, W_in + 1)
    wr_eff = max(wr_cap, 2 * wp_eff)
    wac_eff = max(wac_cap, W_in + 8)
    cols_b = cols.to(torch.int64)
    vals_b, ok_b = vals, ok
    dev = ex.device
    row0 = ex.row0(n_loc)
    rows_g = row0[:, None] + torch.arange(n_loc, device=dev)
    col0 = ex.ranks * c_cap

    _, diag, dinv = _diag_dinv(cols_b, vals_b, ok_b, rows_g)

    # strength (symmetric SOC, smoothed_aggregation.h:56)
    diag_ext = ex.ext_rows(diag, g)
    dj, okd = _gather_ext(diag_ext, cols_b, row0 - g, ok_b)
    thr = theta * torch.sqrt(torch.abs(diag)[..., None] * torch.abs(dj))
    strong = ok_b & okd & (torch.abs(vals_b) >= thr)
    strong = strong & (cols_b != rows_g[..., None])

    # aggregation on the global strength graph; nodes with no strong
    # neighbour stay unaggregated (zero T rows)
    eligible = torch.any(strong, dim=-1)
    roots = _mis2_global(ex, cols_b, strong, eligible, rows_g, row0, g)
    lab = torch.where(roots, rows_g, -1)
    w = torch.where(strong, torch.abs(vals_b), 0)
    lab = _propagate_global(ex, cols_b, strong, w, lab, eligible, row0, g,
                            rounds=_PROP_ROUNDS)
    strag = eligible & (lab < 0)
    roots = roots | strag
    lab = torch.where(strag, rows_g, lab)
    rank = torch.cumsum(roots.to(torch.int64), dim=1) - 1
    nagg = _per_rank(roots)
    overflow = torch.clamp(nagg - c_cap, min=0)
    croot = torch.where(roots,
                        col0[:, None] + torch.clamp(rank, max=c_cap - 1), -1)

    # tentative prolongator: the coarse id of each node's root, fetched
    # through the transfer margin; unit columns
    croot_ext = ex.ext_rows(croot, gP)
    ne = croot_ext.shape[1]
    ridx = lab - (row0 - gP)[:, None]
    ok_r = (lab >= 0) & (ridx >= 0) & (ridx < ne)
    cid = torch.where(ok_r, _flat_take(croot_ext, torch.clamp(ridx, 0,
                                                              ne - 1)), -1)
    t_ok = cid >= 0
    t_cols = torch.where(t_ok, cid, 0)
    t_vals = torch.where(t_ok, torch.ones((), dtype=vals_b.dtype, device=dev),
                         0)

    # P = (I - omega_eff D⁻¹ A) T, coalesced and cut to wp_eff
    tj_c, okj = _gather_ext(ex.ext_rows(t_cols, g), cols_b, row0 - g, ok_b)
    tj_v, _ = _gather_ext(ex.ext_rows(t_vals, g), cols_b, row0 - g, ok_b)
    tj_ok, _ = _gather_ext(ex.ext_rows(t_ok, g), cols_b, row0 - g, ok_b)
    cand_c = torch.cat([t_cols[..., None], tj_c], dim=-1)
    cand_v = torch.cat([t_vals[..., None],
                        -omega_eff * dinv[..., None] * vals_b * tj_v], dim=-1)
    cand_ok = torch.cat([t_ok[..., None], ok_b & okj & tj_ok], dim=-1)
    pc, pv, prn = dedup_rows(cand_c, cand_v, cand_ok, ndev * c_cap)
    p_full = torch.arange(pc.shape[-1], device=dev) < prn[..., None]
    p_cols, p_vals, p_ok, dropped_p = _truncate_by_mag(pc, pv, p_full,
                                                       wp_eff)

    r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok, dropped_g = _galerkin(
        ex, cols_b, vals_b, ok_b, p_cols, p_vals, p_ok, row0, gP, col0,
        c_cap, wr_eff, wac_eff)
    slot = torch.arange(c_cap, device=dev)
    used = slot[None, :] < torch.clamp(nagg, max=c_cap)[:, None]
    ac_c, ac_v, ac_ok = _identity_fill(ac_c, ac_v, ac_ok, used,
                                       col0[:, None] + slot)
    dropped = overflow + dropped_p + dropped_g
    return (p_cols, p_vals, p_ok, r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok,
            dinv, nagg, dropped)


def _classical_level_step(ex, cols, vals, ok, n_loc, g, c_cap, theta,
                          wr_cap, wac_cap):
    """One classical level on every local rank: classical strength, PMIS,
    direct interpolation, R = Pᵀ and Ac (``dist_setup.py:955``)."""
    ndev = ex.ndev
    gP = min(2 * g, ndev * n_loc)
    W = int(cols.shape[-1])
    wp_eff = W
    wr_eff = max(wr_cap, 2 * W)
    wac_eff = max(wac_cap, W + 8)
    cols_b = cols.to(torch.int64)
    vals_b, ok_b = vals, ok
    dev = ex.device
    row0 = ex.row0(n_loc)
    rows_g = row0[:, None] + torch.arange(n_loc, device=dev)
    col0 = ex.ranks * c_cap

    hit, diag, dinv = _diag_dinv(cols_b, vals_b, ok_b, rows_g)

    # classical strength, 'abs' norm (ruge_stuben.h:64): row-local
    offd = ok_b & ~hit
    mag = torch.abs(vals_b)
    mx = torch.amax(torch.where(offd, mag, 0), dim=-1)
    strong = offd & (mag >= theta * mx[..., None]) & (vals_b != 0)

    # PMIS: distance-1 MIS, strong-degree weights, 15-bit hash tie-break
    eligible = torch.any(strong, dim=-1)
    deg = torch.sum(strong.to(torch.int64), dim=-1)
    wts = deg * (1 << 15) + mis_hash(rows_g, 17)
    Cpt = _mis_global(ex, cols_b, strong, eligible, rows_g, row0, g, dist=1,
                      weights=wts)
    ncp = _per_rank(Cpt)
    overflow = torch.clamp(ncp - c_cap, min=0)
    rank = torch.cumsum(Cpt.to(torch.int64), dim=1) - 1
    cid = torch.where(Cpt, col0[:, None] + torch.clamp(rank, max=c_cap - 1),
                      -1)

    # direct interpolation (ruge_stuben.h:777-895)
    cj, okj = _gather_ext(ex.ext_rows(cid, g), cols_b, row0 - g, strong)
    isC = okj & (cj >= 0)
    a = vals_b
    neg = a < 0
    ssn = torch.sum(torch.where(isC & neg, a, 0), dim=-1)
    ssp = torch.sum(torch.where(isC & ~neg, a, 0), dim=-1)
    san = torch.sum(torch.where(offd & neg, a, 0), dim=-1)
    sap = torch.sum(torch.where(offd & ~neg, a, 0), dim=-1)
    no_sp = ssp == 0
    no_sn = ssn == 0
    diag_eff = diag + torch.where(no_sp, sap, 0) + torch.where(no_sn, san, 0)
    alpha = torch.where(no_sn, 0, san / torch.where(no_sn, 1, ssn))
    beta = torch.where(no_sp, 0, sap / torch.where(no_sp, 1, ssp))
    dsafe = torch.where(diag_eff == 0, 1, diag_eff)
    coeff = torch.where(neg, -alpha[..., None] / dsafe[..., None],
                        -beta[..., None] / dsafe[..., None])
    p_vals = torch.where(isC, coeff * a, 0)
    p_vals = torch.where(Cpt[..., None], 0, p_vals)
    p_cols = torch.where(isC, cj, 0)
    p_ok = isC & ~Cpt[..., None]
    own = torch.where(Cpt, cid, 0)
    p_cols[..., 0] = torch.where(Cpt, own, p_cols[..., 0])
    p_vals[..., 0] = torch.where(Cpt, 1, p_vals[..., 0])
    p_ok[..., 0] = torch.where(Cpt, True, p_ok[..., 0])
    pc, pv, prn = dedup_rows(p_cols, p_vals, p_ok, ndev * c_cap)
    p_full = torch.arange(pc.shape[-1], device=dev) < prn[..., None]
    p_cols, p_vals, p_ok, dropped_p = _truncate_by_mag(pc, pv, p_full,
                                                       wp_eff)

    r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok, dropped_g = _galerkin(
        ex, cols_b, vals_b, ok_b, p_cols, p_vals, p_ok, row0, gP, col0,
        c_cap, wr_eff, wac_eff)
    slot = torch.arange(c_cap, device=dev)
    used = slot[None, :] < torch.clamp(ncp, max=c_cap)[:, None]
    ac_c, ac_v, ac_ok = _identity_fill(ac_c, ac_v, ac_ok, used,
                                       col0[:, None] + slot)
    dropped = overflow + dropped_p + dropped_g
    return (p_cols, p_vals, p_ok, r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok,
            dinv, ncp, dropped)


def _densify_replicated(ex, cols, vals, ok, n):
    """The coarsest operator, small, as a dense (n, n) matrix on every
    rank."""
    cols, vals, ok = (ex.gather_rows(a[None]) for a in (cols, vals, ok))
    dense = torch.zeros((n, n), dtype=vals.dtype, device=vals.device)
    rows = torch.arange(n, device=vals.device)[:, None].expand_as(cols)
    dense.index_put_((rows[ok], cols[ok].to(torch.int64)), vals[ok],
                     accumulate=True)
    return dense


def _pinv(dense):
    """The pseudo-inverse with the JAX package's cut-off,
    ``rtol = 10 max(m, n) eps``."""
    m, n = dense.shape
    return torch.linalg.pinv(dense, rtol=10.0 * max(m, n) *
                             torch.finfo(dense.dtype).eps)


def _setup(step, cols, vals, ok, n_loc, mesh, *, max_levels, coarsen_until,
           coarse_ratio, rho_iters, seed, rho_start, transfer, omega,
           smoother="jacobi", cheb_degree=3):
    """The level loop shared by both setups: ``step(ex, cols, vals, ok,
    n_loc, g, c_cap, omega_eff)`` builds one level; ``transfer(g, n_loc)``
    is its transfer margin."""
    ex = exchange_of(mesh)
    ndev = ex.ndev
    levels: List[DistLevel] = []
    diagnostics = {"dropped": [], "nagg": [], "margins": [], "seconds": []}

    def mk(c, v, o, nl, g, **kw):
        return DistLevel(cols=c, vals=v, ok=o, n_loc=nl, g=g, ndev=ndev,
                         mesh=mesh, **kw)

    # one span a level, from the end of the level before; its seconds go
    # to the diagnostics
    level = _trace.span("dist_setup.level", level=0)
    try:
        lc, lv, lo, nl = cols, vals, ok, n_loc
        for lvl_i in range(max_levels):
            n_glob = nl * ndev
            g = _margin_of(ex, lc, lo, nl)
            diagnostics["margins"].append(g)
            if n_glob <= coarsen_until or g >= nl or nl // coarse_ratio < 1:
                break
            c_cap = max(nl // coarse_ratio, 1)
            rho = _power_rho(ex, lc, lv, lo, nl, g, iters=rho_iters,
                             seed=seed + lvl_i, start=rho_start)
            om = omega / max(rho, 1e-30)
            (p_cols, p_vals, p_ok, r_cols, r_vals, r_ok, ac_c, ac_v, ac_ok,
             Dinv, nagg, dropped) = step(ex, *_blocks(ex, nl, lc, lv, lo),
                                         nl, g, c_cap, om)
            gp = transfer(g, nl)
            cheb = None
            if smoother == "chebyshev":
                # reference setup_chebyshev (smoothing.py:627): minimal on
                # [rho(A) / 30, 1.1 rho(A)], applied to b - A x
                from pyamg_tpu_torch.relaxation.chebyshev import \
                    chebyshev_polynomial_coefficients
                rho_A = _power_rho(ex, lc, lv, lo, nl, g, iters=rho_iters,
                                   seed=seed + 37 + lvl_i, use_dinv=False,
                                   start=rho_start)
                co = -chebyshev_polynomial_coefficients(
                    rho_A / 30.0, 1.1 * rho_A, int(cheb_degree))[:-1]
                cheb = torch.as_tensor(co, device=ex.device).to(lv.dtype)
            i32 = torch.int32
            levels.append(mk(
                lc, lv, lo, nl, g, Dinv=Dinv.reshape(-1),
                p_cols=_flat(p_cols)[0].to(i32), p_vals=_flat(p_vals)[0],
                p_ok=_flat(p_ok)[0], r_cols=_flat(r_cols)[0].to(i32),
                r_vals=_flat(r_vals)[0], r_ok=_flat(r_ok)[0],
                omega=float(om), gp=gp, gcp=(-(-gp // nl)) * c_cap,
                cheb=cheb))
            diagnostics["nagg"].append(_read(ex.psum(nagg)[0]))
            diagnostics["dropped"].append(_read(ex.psum(dropped)[0]))
            lc, lv, lo = _flat(ac_c.to(i32), ac_v, ac_ok)
            nl = c_cap
            level.close()
            diagnostics["seconds"].append(level.seconds)
            level = _trace.span("dist_setup.level", level=lvl_i + 1)

        # the coarsest level: replicated, applied through a dense pinv
        g = diagnostics["margins"][-1] if not levels else \
            _margin_of(ex, lc, lo, nl)
        rho = _power_rho(ex, lc, lv, lo, nl, g, iters=rho_iters,
                         seed=seed + 99, start=rho_start)
        levels.append(mk(lc, lv, lo, nl, g,
                         Dinv=_dinv_sharded(ex, lc, lv, lo, nl),
                         omega=float(1.0 / max(rho, 1e-30))))
        nc = nl * ndev
        dense = _densify_replicated(ex, lc, lv, lo, nc)
        hier = DistHierarchy(levels=levels, mesh=mesh,
                             coarse_dense=_pinv(dense), coarse_n=nc,
                             diagnostics=diagnostics)
    finally:
        level.close()
    diagnostics["seconds"].append(level.seconds)
    return hier


def distributed_sa_setup(cols, vals, ok, n_loc, mesh, theta=0.0,
                         omega=4.0 / 3.0, max_levels=10, coarsen_until=4096,
                         coarse_ratio=4, wp_cap=12, wr_cap=48, wac_cap=24,
                         rho_iters=12, seed=0, smoother="jacobi",
                         cheb_degree=3, rho_start=None):
    """An SA hierarchy of a row-split operator (``dist_stencil_grid``,
    ``dist_from_scipy``): symmetric strength, MIS-2 and label propagation
    on the global strength graph, constant tentative prolongator,
    Jacobi-smoothed P, Galerkin product (``dist_setup.py:790``).

    ``mesh``: a ``RowMesh`` (one rank a process) or a ``StackedMesh``
    (every rank in this process).  ``coarse_ratio``: ``c_cap = n_loc //
    coarse_ratio`` coarse slots a rank.  ``wp_cap``/``wr_cap``/``wac_cap``:
    width caps of P/R/Ac rows (drops in ``diagnostics["dropped"]``).
    ``smoother``: ``"jacobi"`` or ``"chebyshev"``.  ``rho_start(seed, rank,
    n_loc)``: the start vector of each power iteration on each rank
    (default ``random_start``); the seam through which a test hands the
    port another package's start vectors.  ``diagnostics["seconds"]``
    holds each level's seconds (the last: the coarsest level)."""
    def step(ex, c, v, o, nl, g, c_cap, om):
        return _level_step(ex, c, v, o, nl, g, c_cap, theta, om, wp_cap,
                           wr_cap, wac_cap)

    ndev = int(mesh.size)
    return _setup(step, cols, vals, ok, n_loc, mesh, max_levels=max_levels,
                  coarsen_until=coarsen_until, coarse_ratio=coarse_ratio,
                  rho_iters=rho_iters, seed=seed, rho_start=rho_start,
                  transfer=lambda g, nl: _transfer_margin(g, nl, ndev),
                  omega=omega, smoother=smoother, cheb_degree=cheb_degree)


def distributed_classical_setup(cols, vals, ok, n_loc, mesh, theta=0.25,
                                omega=4.0 / 5.0, max_levels=10,
                                coarsen_until=4096, coarse_ratio=2,
                                wr_cap=48, wac_cap=32, rho_iters=12, seed=0,
                                rho_start=None):
    """A classical (Ruge-Stuben-style) hierarchy of a row-split operator:
    classical strength, PMIS (distance-1 Luby MIS with strong-degree
    weights), direct interpolation, R = Pᵀ, Galerkin product
    (``dist_setup.py:883``); damped-Jacobi smoothing in the solve.
    ``mesh`` and ``rho_start`` as for ``distributed_sa_setup``."""
    def step(ex, c, v, o, nl, g, c_cap, om):
        return _classical_level_step(ex, c, v, o, nl, g, c_cap,
                                     float(theta), wr_cap, wac_cap)

    ndev = int(mesh.size)
    return _setup(step, cols, vals, ok, n_loc, mesh, max_levels=max_levels,
                  coarsen_until=coarsen_until, coarse_ratio=coarse_ratio,
                  rho_iters=rho_iters, seed=seed, rho_start=rho_start,
                  transfer=lambda g, nl: min(2 * g, ndev * nl), omega=omega)
