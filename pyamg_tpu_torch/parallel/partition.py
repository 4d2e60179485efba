"""Row partitions of a hierarchy over the ranks of a process group
(counterpart of ``pyamg_tpu/parallel/partition.py``).

The JAX package places each level's arrays on a device mesh and lets GSPMD
insert the collectives.  Here each rank of a ``torch.distributed`` group
holds its own block of rows, and the collectives are written where they
go:

* a sharded level's rows are padded to a multiple of the group's size
  (square operators with unit-diagonal rows, so that smoothers stay
  defined; padded vector entries stay exactly zero through every cycle
  op), and rank r keeps rows ``[r n_loc, (r + 1) n_loc)``;
* an operator on a sharded level is a ``ShardedELL``: the rank's rows with
  global column indices.  Where its input is split by rows it first
  gathers the input from every rank (``all_gather_into_tensor``), which is
  the all-gather GSPMD inserts for the ``x[cols]`` gather;
  ``parallel/halo.py``'s ``HaloELL`` exchanges only the halo instead;
* inner products on a sharded level are the local ``vdot`` followed by
  one ``all_reduce`` (``ShardedReduction``), the ``psum`` GSPMD inserts;
* levels of ``replicate_below`` rows or fewer, and every level that is not
  an ELL, are whole on every rank: the coarse tail runs redundantly, with
  no collective.

Every collective enqueues on the current stream and nothing here reads a
tensor on the host, so a sharded solve can be captured (on an NCCL
group; ``MultilevelSolver`` does).  The wrappers count their calls in
``COUNTS`` (reset by ``reset_counts``) through ``_graph.tally``, so that
a replayed graph counts the calls it recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from pyamg_tpu_torch import _graph
from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.sparse.matrix import ELL

COUNTS = {"all_gather": 0, "all_reduce": 0, "send": 0, "recv": 0}

# smoothers that reach the operator only through its product and keep
# per-row arrays, which are padded and split with the rows
SHARDED_SMOOTHERS = ("none", "custom", "jacobi", "richardson",
                     "gauss_seidel", "polynomial", "cf_jacobi", "fc_jacobi")


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def _add(counts):
    for kind, n in counts.items():
        COUNTS[kind] += n


def count(kind, n=1):
    """Count ``n`` calls of the collective ``kind`` in ``COUNTS``: now, or
    on every run of the graph being recorded (``_graph.tally``)."""
    _graph.tally(_add, kind, n)


@dataclasses.dataclass(frozen=True, eq=False)
class RowMesh:
    """The ranks of ``group`` over which rows are split: ``size`` ranks,
    this process's ``rank`` and ``device``, and ``ranks``, the global rank
    of each group rank (point-to-point messages name global ranks)."""

    group: object
    size: int
    rank: int
    device: torch.device
    ranks: Tuple[int, ...]

    @property
    def reduction(self):
        return ShardedReduction(self)


def make_row_mesh(n_devices=None, group=None, device=None) -> RowMesh:
    """The row mesh of ``group`` (the default group when None), which the
    caller has initialised with ``torch.distributed.init_process_group``.
    ``n_devices``, when given, must equal the group's size.  ``device``
    defaults to ``cuda:{rank % device_count}``, so it raises without a
    card; pass ``device="cpu"`` to run on the CPU (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_row_mesh needs torch.distributed: call "
                           "torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} ranks")
    rank = dist.get_rank(group)
    if device is None:
        resolve("cuda")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return RowMesh(group, size, rank, resolve(device),
                   tuple(dist.get_process_group_ranks(group)))


def all_gather(x, mesh: RowMesh):
    """Every rank's rows of x, in rank order: one
    ``all_gather_into_tensor``."""
    x = x.contiguous()
    out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=mesh.group)
    count("all_gather")
    return out


def all_reduce(t, mesh: RowMesh):
    """The sum of ``t`` over the ranks (in place): one ``all_reduce``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    count("all_reduce")
    return t


class ShardedReduction:
    """Inner products of vectors split by rows over ``mesh``: the local
    product, then one ``all_reduce``, so that every rank holds the same
    value (the stop flags of the Krylov loops are read from these only)."""

    def __init__(self, mesh: RowMesh):
        self.mesh = mesh

    def dot(self, a, b):
        return all_reduce(torch.vdot(a, b), self.mesh)

    def norm(self, v):
        return torch.sqrt(torch.real(self.dot(v, v)))

    def dots(self, V, u):
        return all_reduce((V.conj() if V.is_complex() else V) @ u, self.mesh)


class RowSharded:
    """Marker of the operators whose rows or input are split over a
    ``RowMesh`` (``ShardedELL``, ``halo.HaloELL``).  ``matvec`` is the
    product, ``rmatvec`` the product with Aᴴ (the normal-equation Krylov
    methods take both)."""

    mesh: RowMesh

    def matvec(self, x):
        return self.mv(x)


def _ell_mv(cols, vals, x):
    """sum_k vals[i, k] x[cols[i, k]]: the expression of ``ops.spmv.spmv``
    for a 1-D x (so that a row's slots sum in the same order), with the
    columns of a 2-D x broadcast."""
    if x.ndim == 1:
        return torch.sum(vals * x[cols], dim=1)
    return torch.sum(vals[..., None] * x[cols], dim=1)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedELL(RowSharded):
    """An ELL operator over a ``RowMesh``.  ``local`` holds the rows this
    rank computes, with global column indices into the input: its block of
    the padded rows where ``out_sharded``, else every row.  Where
    ``in_sharded`` the input is split by rows and is gathered from every
    rank first; else it is whole on every rank.  ``shape`` is the global
    (padded) shape, ``nnz`` the stored entries of every rank."""

    local: ELL
    shape: Tuple[int, int]
    mesh: RowMesh
    in_sharded: bool = True
    out_sharded: bool = True
    _nnz: int = 0

    @property
    def dtype(self):
        return self.local.vals.dtype

    @property
    def nnz(self) -> int:
        return self._nnz

    @property
    def n_loc(self) -> int:
        return self.local.shape[0]

    def mv(self, x):
        if self.in_sharded:
            x = all_gather(x, self.mesh)
        return _ell_mv(self.local.cols, self.local.vals, x)

    __matmul__ = mv

    def rmatvec(self, v):
        """The rank's block of Aᴴ v of a square operator split by rows:
        each rank adds its rows' part into a whole-length vector, one
        ``all_reduce`` sums the parts, and the rank keeps its block."""
        if not (self.in_sharded and self.out_sharded):
            raise TypeError("rmatvec takes a square operator split by rows")
        A = self.local
        out = torch.zeros((self.shape[1],), dtype=v.dtype, device=v.device)
        out.index_add_(0, A.cols.reshape(-1).to(torch.int64),
                       (A.vals.conj() * v[:, None]).reshape(-1))
        lo = self.mesh.rank * self.n_loc
        return all_reduce(out, self.mesh)[lo:lo + self.n_loc]

    def diagonal(self):
        """The rank's block of diag(A) of a square operator split by rows
        (a padded row reads 1)."""
        A = self.local
        first = self.mesh.rank * self.n_loc if self.out_sharded else 0
        rows = first + torch.arange(A.shape[0], device=A.cols.device)
        slots = torch.arange(A.width, device=A.cols.device)
        hit = (A.cols == rows[:, None]) & (slots[None, :] < A.row_nnz[:, None])
        return torch.sum(torch.where(hit, A.vals, 0), dim=1)

    def __repr__(self):
        return (f"ShardedELL(shape={self.shape}, rank={self.mesh.rank}/"
                f"{self.mesh.size}, in_sharded={self.in_sharded}, "
                f"out_sharded={self.out_sharded}, dtype={self.dtype})")


def host_ell(A: ELL) -> ELL:
    """A (host or placed) ELL with numpy arrays."""
    def np_(v, dtype=None):
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return v if dtype is None else v.astype(dtype, copy=False)
    return dataclasses.replace(A, cols=np_(A.cols, np.int32), vals=np_(A.vals),
                               row_nnz=np_(A.row_nnz, np.int32))


def pad_matrix_rows(A: ELL, multiple: int, identity_pad=True) -> ELL:
    """A host ELL with its rows padded to a multiple of ``multiple``; on a
    square operator (with ``identity_pad``) the padded rows get a unit
    diagonal at the padded coordinates, and its columns grow with them."""
    A = host_ell(A)
    n, m = A.shape
    npad = (-n) % multiple
    if npad == 0:
        return A
    W = A.width
    pc = np.zeros((npad, W), np.int32)
    pv = np.zeros((npad, W), A.vals.dtype)
    prn = np.zeros((npad,), np.int32)
    if identity_pad and n == m:
        pc[:, 0] = n + np.arange(npad, dtype=np.int32)
        pv[:, 0] = 1
        prn[:] = 1
    new_m = m + npad if n == m else m
    return ELL(np.concatenate([A.cols, pc]), np.concatenate([A.vals, pv]),
               np.concatenate([A.row_nnz, prn]), (n + npad, new_m))


def _pad_square(A: ELL, multiple: int) -> ELL:
    """A square operator's rows and columns padded with unit-diagonal
    rows."""
    n, m = A.shape
    if n != m:
        raise ValueError(f"_pad_square takes a square operator, not {A.shape}")
    return pad_matrix_rows(A, multiple, identity_pad=True)


def _rows(A: ELL, lo, hi, mesh):
    """Rows [lo, hi) of a host ELL on the mesh's device."""
    return ELL(A.cols[lo:hi], A.vals[lo:hi], A.row_nnz[lo:hi],
               (hi - lo, A.shape[1])).to(mesh.device)


def shard_matrix(A: ELL, mesh: RowMesh, in_sharded=True) -> ShardedELL:
    """The rank's block of the rows of ``A`` (an ELL whose rows are a
    multiple of the mesh's size: pad it with ``pad_matrix_rows`` first),
    with global column indices, on ``mesh.device``.  ``in_sharded``: the
    input is split by rows (gathered before each product) or whole."""
    if not isinstance(A, ELL):
        raise TypeError(f"shard_matrix takes an ELL, not {type(A).__name__}")
    A = host_ell(A)
    n = A.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks: "
                         f"pad them with pad_matrix_rows")
    n_loc = n // mesh.size
    lo = mesh.rank * n_loc
    return ShardedELL(_rows(A, lo, lo + n_loc, mesh), A.shape, mesh,
                      in_sharded=in_sharded, _nnz=int(A.row_nnz.sum()))


def replicate(A, mesh: RowMesh):
    """The whole of ``A`` (an operator, an array or a dict of them) on
    ``mesh.device``."""
    from pyamg_tpu_torch.multilevel import _put
    return _put(A, mesh.device)


def _pad_vec(v, multiple, name=""):
    """A host vector padded with zeros to a multiple of ``multiple`` rows
    (``colors`` with -1, which no color pass updates)."""
    v = np.asarray(v)
    npad = (-v.shape[0]) % multiple
    if npad == 0:
        return v
    fill = -1 if name == "colors" else 0
    return np.concatenate([v, np.full((npad,) + v.shape[1:], fill, v.dtype)])


def _block(v, mesh: RowMesh):
    """The rank's block of the rows of a host array split over the mesh."""
    n_loc = v.shape[0] // mesh.size
    return v[mesh.rank * n_loc:(mesh.rank + 1) * n_loc]


def shard_vector(v, mesh: RowMesh):
    """The rank's block of the rows of ``v``, padded with zeros to a
    multiple of the mesh's size, on ``mesh.device``."""
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    return as_tensor(_block(_pad_vec(v, mesh.size), mesh), mesh.device)


def _pad_params(params, n, multiple):
    """Smoother params of a level of ``n`` rows with each per-row array
    padded to a multiple of ``multiple`` rows (``_pad_vec``); other entries
    as they are."""
    n_pad = n + (-n) % multiple
    out = {}
    for k, v in params.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1 and \
                v.shape[0] in (n, n_pad):
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            v = _pad_vec(v, multiple, k)
        out[k] = v
    return out


def _shard_params(params, n, mesh: RowMesh):
    """Per-row smoother params padded (``_pad_params``) and split with the
    rows; the rest (scalars, small arrays) whole, all on ``mesh.device``."""
    n_pad = n + (-n) % mesh.size
    out = {}
    for k, v in _pad_params(params, n, mesh.size).items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_pad:
            v = _block(v, mesh)
        out[k] = replicate(v, mesh)
    return out


def _transfer(op, mesh: RowMesh, rows_sharded, in_sharded):
    """A transfer operator (P or R) between two levels: whole where
    neither its rows nor its input are split, else a ``ShardedELL`` with
    its rows split (padded with zero rows) where ``rows_sharded``."""
    if not (rows_sharded or in_sharded):
        return replicate(op, mesh)
    if not isinstance(op, ELL):
        raise TypeError(f"shard_hierarchy takes ELL transfers next to a "
                        f"sharded level, not {type(op).__name__}: shard the "
                        f"hierarchy before compress_stencils")
    if rows_sharded:
        return shard_matrix(pad_matrix_rows(op, mesh.size,
                                            identity_pad=False), mesh,
                            in_sharded=in_sharded)
    A = host_ell(op)
    return ShardedELL(_rows(A, 0, A.shape[0], mesh), A.shape, mesh,
                      in_sharded=in_sharded, out_sharded=False,
                      _nnz=int(A.row_nnz.sum()))


def _check_smoothers(i, *smoothers):
    """Raise unless every smoother of level i has a row-sharded form."""
    for kind, _, _ in smoothers:
        if kind not in SHARDED_SMOOTHERS:
            raise TypeError(
                f"level {i}: the {kind!r} smoother reads the operator's "
                f"arrays or takes inner products of its own, and has no "
                f"row-sharded form; sharded levels take "
                f"{', '.join(SHARDED_SMOOTHERS)}")


def shard_operator(A, mesh: RowMesh, spmv="gspmd"):
    """A square level operator (host or placed ELL) split by rows:
    ``spmv="gspmd"`` a ``ShardedELL`` that gathers its input,
    ``"halo"`` a ``halo.HaloELL``."""
    if spmv == "halo":
        from pyamg_tpu_torch.parallel.halo import build_halo
        return build_halo(A, mesh)
    if spmv != "gspmd":
        raise ValueError(f"unknown spmv {spmv!r}: 'gspmd' or 'halo'")
    return shard_matrix(_pad_square(A, mesh.size), mesh)


def shard_hierarchy(ml, mesh: RowMesh, replicate_below=2048, spmv="gspmd"):
    """Split a ``MultilevelSolver``'s levels over ``mesh``, in place.

    A level is sharded when it has more than ``replicate_below`` rows and
    its operator is an ELL: its rows are padded to a multiple of the
    mesh's size and each rank keeps its block (``spmv="gspmd"``: a
    ``ShardedELL`` that gathers the whole input before each product;
    ``"halo"``: a ``HaloELL`` that exchanges only the halo).  Its P takes
    the coarse level's vectors (gathered where the coarse level is
    sharded) and its R gives them (its rows split where the coarse level
    is sharded, else every coarse row on every rank from a gathered fine
    vector); its smoothers' per-row arrays are padded (colors -1,
    everything else 0) and split.  Every other level, and the coarse
    solver, is whole on every rank.  Sets ``ml._fine_n`` (the unpadded fine
    rows) and ``ml._mesh``, places every level on ``mesh.device`` and
    returns ml."""
    if spmv not in ("gspmd", "halo"):
        raise ValueError(f"unknown spmv {spmv!r}: 'gspmd' or 'halo'")
    ml._drop_graphs()
    levels = ml.levels
    sharded = [l.A.shape[0] > replicate_below and isinstance(l.A, ELL)
               for l in levels]
    if sharded[-1]:
        raise NotImplementedError(
            f"the coarsest level ({levels[-1].A.shape[0]} rows) would be "
            f"sharded; the coarse solve runs on a whole level: raise "
            f"replicate_below or coarsen further")
    for i, lvl in enumerate(levels):
        if sharded[i]:
            _check_smoothers(i, lvl.pre, lvl.post)
    fine_n = levels[0].A.shape[0]
    for i, lvl in enumerate(levels):
        fine = sharded[i]
        coarse = i + 1 < len(levels) and sharded[i + 1]
        n = lvl.A.shape[0]
        lvl.A = shard_operator(lvl.A, mesh, spmv) if fine else \
            replicate(lvl.A, mesh)
        if lvl.P is not None:
            lvl.P = _transfer(lvl.P, mesh, rows_sharded=fine,
                              in_sharded=coarse)
        if lvl.R is not None:
            lvl.R = _transfer(lvl.R, mesh, rows_sharded=coarse,
                              in_sharded=fine)
        for attr in ("pre", "post"):
            kind, sopts, params = getattr(lvl, attr)
            params = _shard_params(params, n, mesh) if fine else \
                replicate(params, mesh)
            setattr(lvl, attr, (kind, sopts, params))
    ml.coarse_solver.params = replicate(ml.coarse_solver.params, mesh)
    ml._fine_n = fine_n
    ml._mesh = mesh
    ml.device = mesh.device
    return ml


def sharded_mesh(A):
    """The mesh of a row-sharded operator (or of an operator built on one,
    which names it as ``mesh``), else None."""
    mesh = getattr(A, "mesh", None)
    return mesh if isinstance(mesh, RowMesh) else None
