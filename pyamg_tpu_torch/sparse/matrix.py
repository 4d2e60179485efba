"""Sparse containers of the port (counterpart of ``pyamg_tpu/sparse/matrix.py``).

* ``ELL`` -- padded-row sparse matrix.  The setup phase builds and uses it
  with numpy arrays; ``to(device)`` turns it into tensors for the rare
  level that stays uncompressed in the solve phase.
* ``BELL`` -- padded-row block sparse matrix (the BSR analogue):
  ``(nb, W)`` block columns and ``(nb, W, br, bc)`` dense blocks.  Its
  product is a gather of x's blocks and one einsum (``ops/spmv.bspmv``).
* ``DIA`` -- banded matrix, ``data[d, i] = A[i, i + offsets[d]]``, row-padded
  to a multiple of ``DIA_TILE`` with zeros; ``shape`` keeps the logical
  size.  Its product is kernel K1 (``ops/dia_kernels.py``).
* ``PhaseStencil`` -- grid-structured transfer operator (P, and R through
  ``trans=True``): per-phase shifted elementwise products on the coarse
  grid, written as torch slice ops.

The setup phase works on numpy arrays, the solve phase on tensors; ``to``
moves a container from the first to the second.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pyamg_tpu_torch._device import as_tensor

# row padding of DIA data (kept from the reference layout; the CUDA
# kernels read only the logical rows)
DIA_TILE = 8192


def _astype(a, dtype):
    """A numpy array or a tensor in ``dtype`` (a numpy or torch dtype)."""
    if isinstance(a, torch.Tensor):
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return a.to(dtype)
    return a.astype(dtype)


class _Shape:
    """``n_rows`` and ``n_cols`` of a container's ``shape``."""

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]


@dataclasses.dataclass(frozen=True)
class ELL(_Shape):
    """Padded-row sparse matrix: ``cols``/``vals`` ``(n, W)``, ``row_nnz``
    ``(n,)``.  Padding slots hold column 0 and value 0.  ``grid`` and
    ``col_grid`` are optional C-order tensor-grid shapes of the row and
    column index spaces."""

    cols: object
    vals: object
    row_nnz: object
    shape: Tuple[int, int]
    grid: Tuple[int, ...] = None
    col_grid: Tuple[int, ...] = None

    @property
    def width(self) -> int:
        return self.cols.shape[1] if self.cols.ndim == 2 else 0

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        """Number of stored entries (explicit zeros included)."""
        return int(self.row_nnz.sum())

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (1, 1)

    def valid_mask(self):
        """(n, W) bool: True for stored entries (host arrays)."""
        return np.arange(self.width)[None, :] < np.asarray(self.row_nnz)[:, None]

    def mv(self, x):
        from pyamg_tpu_torch.ops.spmv import spmv
        return spmv(self, x)

    def __matmul__(self, other):
        from pyamg_tpu_torch.ops import matmul
        return matmul(self, other)

    @property
    def T(self):
        """The transpose (host arrays)."""
        from pyamg_tpu_torch.ops.transpose import transpose
        return transpose(self)

    @property
    def H(self):
        """The conjugate transpose (host arrays)."""
        from pyamg_tpu_torch.ops.transpose import transpose
        return transpose(self, conjugate=True)

    def diagonal(self):
        from pyamg_tpu_torch.ops.spmv import extract_diagonal
        return extract_diagonal(self)

    def astype(self, dtype):
        return dataclasses.replace(self, vals=_astype(self.vals, dtype))

    def to(self, device) -> "ELL":
        return dataclasses.replace(
            self, cols=as_tensor(self.cols, device, torch.long),
            vals=as_tensor(self.vals, device),
            row_nnz=as_tensor(self.row_nnz, device, torch.int32))

    def __repr__(self):
        return (f"ELL(shape={self.shape}, width={self.width}, "
                f"dtype={self.vals.dtype})")


@dataclasses.dataclass(frozen=True)
class BELL(_Shape):
    """Padded-row block sparse matrix: ``cols[i, k]`` is the block column
    of the k-th stored block of block row i, ``vals[i, k]`` that dense
    ``(br, bc)`` block, ``row_nnz`` the stored blocks per block row.
    Padding slots hold block column 0 and a zero block.  ``shape`` is the
    scalar shape; the block grid is ``(shape[0] // br, shape[1] // bc)``."""

    cols: object
    vals: object
    row_nnz: object
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]

    @property
    def n_block_rows(self) -> int:
        return self.shape[0] // self.blocksize[0]

    @property
    def n_block_cols(self) -> int:
        return self.shape[1] // self.blocksize[1]

    @property
    def width(self) -> int:
        return self.cols.shape[1] if self.cols.ndim == 2 else 0

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        """Stored scalar entries (every entry of every stored block)."""
        br, bc = self.blocksize
        return int(self.row_nnz.sum()) * br * bc

    def valid_mask(self):
        """(nb, W) bool: True for stored blocks (host arrays)."""
        return np.arange(self.width)[None, :] < \
            np.asarray(self.row_nnz)[:, None]

    def mv(self, x):
        from pyamg_tpu_torch.ops.spmv import bspmv
        return bspmv(self, x)

    def __matmul__(self, other):
        from pyamg_tpu_torch.ops import matmul
        return matmul(self, other)

    @property
    def T(self):
        """The transpose, every block transposed (host arrays)."""
        from pyamg_tpu_torch.ops.transpose import btranspose
        return btranspose(self)

    @property
    def H(self):
        """The conjugate transpose (host arrays)."""
        from pyamg_tpu_torch.ops.transpose import btranspose
        return btranspose(self, conjugate=True)

    def astype(self, dtype):
        return dataclasses.replace(self, vals=_astype(self.vals, dtype))

    def to(self, device) -> "BELL":
        return dataclasses.replace(
            self, cols=as_tensor(self.cols, device, torch.long),
            vals=as_tensor(self.vals, device),
            row_nnz=as_tensor(self.row_nnz, device, torch.int32))

    def __repr__(self):
        return (f"BELL(shape={self.shape}, blocksize={self.blocksize}, "
                f"width={self.width}, dtype={self.vals.dtype})")


@dataclasses.dataclass(frozen=True)
class DIA(_Shape):
    """Banded sparse matrix; ``data`` is ``(ndiag, npad)`` with
    ``npad % DIA_TILE == 0`` and zeros outside the band and bounds."""

    data: object
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        if isinstance(self.data, torch.Tensor):
            return int(torch.count_nonzero(self.data))
        return int(np.count_nonzero(self.data))

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (1, 1)

    def mv(self, x):
        from pyamg_tpu_torch.ops.spmv import dia_spmv
        return dia_spmv(self, x)

    __matmul__ = mv

    def diagonal(self):
        n = self.shape[0]
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)][:n]
        if isinstance(self.data, torch.Tensor):
            return torch.zeros((n,), dtype=self.data.dtype,
                               device=self.data.device)
        return np.zeros((n,), self.data.dtype)

    def astype(self, dtype):
        return DIA(_astype(self.data, dtype), self.offsets, self.shape)

    def to(self, device) -> "DIA":
        return DIA(as_tensor(self.data, device), self.offsets, self.shape)

    def __repr__(self):
        return (f"DIA(shape={self.shape}, ndiags={len(self.offsets)}, "
                f"dtype={self.data.dtype})")


def dia_from_ell(A: ELL, max_diags: int = 64):
    """Square host ELL -> DIA when at most ``max_diags`` distinct offsets
    hold nonzeros; None otherwise (setup phase)."""
    if A.shape[0] != A.shape[1]:
        return None
    n = A.shape[0]
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    live = A.valid_mask() & (vals != 0)
    offs = cols.astype(np.int32, copy=False) - \
        np.arange(n, dtype=np.int32)[:, None]
    if not live.any():
        return None
    omin = int(offs[live].min())
    omax = int(offs[live].max())
    if omax - omin <= 4_000_000:
        hist = np.bincount((offs - omin).ravel()[live.ravel()])
        uniq = np.flatnonzero(hist) + omin
    else:
        uniq = np.unique(offs[live])
    if len(uniq) == 0 or len(uniq) > max_diags:
        return None
    lutarr = np.full(omax - omin + 1, -1, np.int32)
    lutarr[uniq - omin] = np.arange(len(uniq), dtype=np.int32)
    npad = -(-n // DIA_TILE) * DIA_TILE
    data = np.zeros((len(uniq), npad), vals.dtype)
    d2 = lutarr[np.clip(offs - omin, 0, omax - omin)]
    rows2 = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None],
                            offs.shape)
    data[d2[live], rows2[live]] = vals[live]
    return DIA(data, tuple(int(o) for o in uniq), (n, n))


@dataclasses.dataclass(frozen=True)
class PhaseStencil:
    """Grid-structured transfer operator.

    Fine node with grid coords ``x`` sits in coarse cell ``q = x // ratio``
    with phase ``p = x % ratio``; its columns are the cells ``q + off`` for
    the phase's few static offsets, so

        (P x)[cell q, phase p] = sum_k arrays[p][k, q] * X[q + off[p][k]]

    and ``trans=True`` applies the adjoint (R = P^T) from the same arrays.
    """

    arrays: Tuple[object, ...]          # per phase: (n_off_p, *col_grid)
    offsets: Tuple[Tuple[Tuple[int, ...], ...], ...]
    row_grid: Tuple[int, ...]
    col_grid: Tuple[int, ...]
    ratio: Tuple[int, ...]
    trans: bool = False
    _nnz: int = 0

    @property
    def shape(self) -> Tuple[int, int]:
        nf = int(np.prod(self.row_grid))
        nc = int(np.prod(self.col_grid))
        return (nc, nf) if self.trans else (nf, nc)

    @property
    def dtype(self):
        return self.arrays[0].dtype

    @property
    def nnz(self) -> int:
        return self._nnz

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (1, 1)

    @property
    def T(self):
        return dataclasses.replace(self, trans=not self.trans)

    @property
    def H(self):
        """The adjoint: the transpose of the conjugated arrays."""
        a = self.arrays[0]
        if (a.is_complex() if isinstance(a, torch.Tensor)
                else np.iscomplexobj(a)):
            return dataclasses.replace(
                self, arrays=tuple(x.conj() for x in self.arrays),
                trans=not self.trans)
        return self.T

    def astype(self, dtype):
        return dataclasses.replace(
            self, arrays=tuple(_astype(a, dtype) for a in self.arrays))

    def to(self, device) -> "PhaseStencil":
        return dataclasses.replace(
            self, arrays=tuple(as_tensor(a, device) for a in self.arrays))

    def __repr__(self):
        return (f"PhaseStencil(row_grid={self.row_grid}, "
                f"col_grid={self.col_grid}, ratio={self.ratio}, "
                f"trans={self.trans}, dtype={self.dtype})")

    def _extents(self):
        nd = len(self.col_grid)
        lo = [0] * nd
        hi = [0] * nd
        for offs in self.offsets:
            for off in offs:
                for d in range(nd):
                    lo[d] = max(lo[d], -off[d])
                    hi[d] = max(hi[d], off[d])
        return tuple(lo), tuple(hi)

    def _by_offset(self):
        """{offset: [(phase, slot)]}: terms grouped by shift."""
        groups = {}
        for p in range(len(self.arrays)):
            for k, off in enumerate(self.offsets[p]):
                groups.setdefault(tuple(off), []).append((p, k))
        return groups

    def mv(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 1:
            raise ValueError("PhaseStencil.mv takes a 1-D vector")
        return self._rmv(x) if self.trans else self._fmv(x)

    __matmul__ = mv

    @staticmethod
    def _pad(X, lo, hi):
        # F.pad lists (before, after) pairs from the last dimension back
        widths = []
        for d in reversed(range(X.ndim)):
            widths += [lo[d], hi[d]]
        return F.pad(X, widths)

    def _fmv(self, x: torch.Tensor) -> torch.Tensor:
        """y = P @ x (fine output)."""
        cg, rg, r = self.col_grid, self.row_grid, self.ratio
        nd = len(cg)
        lo, hi = self._extents()
        X = self._pad(x.reshape(cg), lo, hi)
        shifted = {}
        for off in self._by_offset():
            sl = tuple(slice(lo[d] + off[d], lo[d] + off[d] + cg[d])
                       for d in range(nd))
            shifted[off] = X[sl]
        phases = []
        for p in range(len(self.arrays)):
            arr = self.arrays[p]
            acc = None
            for k, off in enumerate(self.offsets[p]):
                term = arr[k] * shifted[tuple(off)]
                acc = term if acc is None else acc + term
            if acc is None:
                acc = x.new_zeros(cg)
            phases.append(acc)
        Y = torch.stack(phases).reshape(tuple(r) + tuple(cg))
        # (r0..rk, c0..ck) -> (c0, r0, c1, r1, ...)
        axes = []
        for d in range(nd):
            axes += [nd + d, d]
        Y = Y.permute(axes).reshape(tuple(cg[d] * r[d] for d in range(nd)))
        Y = Y[tuple(slice(0, rg[d]) for d in range(nd))]
        return Y.reshape(-1)

    def _rmv(self, y: torch.Tensor) -> torch.Tensor:
        """x = P.T @ y (coarse output): the mirrored shifted reads of the
        per-offset products."""
        cg, rg, r = self.col_grid, self.row_grid, self.ratio
        nd = len(cg)
        lo, hi = self._extents()
        Y = self._pad(y.reshape(rg), (0,) * nd,
                      tuple(cg[d] * r[d] - rg[d] for d in range(nd)))
        phase_cache = {}

        def phase(pidx):
            if pidx not in phase_cache:
                starts = np.unravel_index(pidx, r)
                phase_cache[pidx] = Y[tuple(
                    slice(int(starts[d]), cg[d] * r[d], r[d])
                    for d in range(nd))]
            return phase_cache[pidx]

        M = tuple(max(lo[d], hi[d]) for d in range(nd))
        out = None
        for off, terms in self._by_offset().items():
            prod = None
            for (p, k) in terms:
                t = self.arrays[p][k] * phase(p)
                prod = t if prod is None else prod + t
            Ppad = self._pad(prod, M, M)
            sl = tuple(slice(M[d] - off[d], M[d] - off[d] + cg[d])
                       for d in range(nd))
            t = Ppad[sl]
            out = t if out is None else out + t
        if out is None:
            out = y.new_zeros(cg)
        return out.reshape(-1)


def phase_stencil_from_ell(P: ELL, row_grid, col_grid, max_offsets=48,
                           max_reach=4):
    """Grid-structured host ELL transfer operator -> ``PhaseStencil``;
    None when the operator is not phase-structured (setup phase)."""
    row_grid = tuple(int(g) for g in row_grid)
    col_grid = tuple(int(g) for g in col_grid)
    nd = len(row_grid)
    if len(col_grid) != nd:
        return None
    nf = int(np.prod(row_grid))
    nc = int(np.prod(col_grid))
    if P.shape != (nf, nc):
        return None
    ratio = tuple(-(-row_grid[d] // col_grid[d]) for d in range(nd))
    if any(r < 1 for r in ratio):
        return None

    cols = np.asarray(P.cols)
    vals = np.asarray(P.vals)
    valid = P.valid_mask() & (vals != 0)
    rows_i, slot_k = np.nonzero(valid)
    if len(rows_i) == 0:
        return None
    fcoord = np.stack(np.unravel_index(rows_i, row_grid), axis=1)
    ccoord = np.stack(np.unravel_index(cols[rows_i, slot_k], col_grid),
                      axis=1)
    rat = np.array(ratio)
    cell = fcoord // rat
    if np.any(cell >= np.array(col_grid)):
        return None
    phase = fcoord % rat
    off = ccoord - cell
    if np.abs(off).max() > max_reach:
        return None
    pidx = np.ravel_multi_index(phase.T, ratio)
    cellidx = np.ravel_multi_index(cell.T, col_grid)
    v = vals[rows_i, slot_k]

    nphase = int(np.prod(ratio))
    arrays, offsets = [], []
    total_offs = 0
    for p in range(nphase):
        m = pidx == p
        if not m.any():
            arrays.append(np.zeros((0,) + col_grid, vals.dtype))
            offsets.append(())
            continue
        uniq, inv = np.unique(off[m], axis=0, return_inverse=True)
        total_offs += len(uniq)
        if total_offs > max_offsets:
            return None
        arr = np.zeros((len(uniq), nc), vals.dtype)
        np.add.at(arr, (inv.reshape(-1), cellidx[m]), v[m])
        arrays.append(arr.reshape((len(uniq),) + col_grid))
        offsets.append(tuple(tuple(int(o) for o in u) for u in uniq))
    nnz = int(np.count_nonzero(vals[valid]))
    return PhaseStencil(tuple(arrays), tuple(offsets), row_grid, col_grid,
                        ratio, trans=False, _nnz=nnz)


def ell_from_csr_arrays(indptr, indices, data, shape, width=None,
                        min_width: int = 1) -> ELL:
    """Host ELL from CSR triplet arrays (column-sorted rows keep order)."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    n = shape[0]
    row_nnz = np.diff(indptr).astype(np.int32)
    W = int(max(min_width, row_nnz.max() if n else 0)) if width is None \
        else int(width)
    cols = np.zeros((n, W), dtype=np.int32)
    vals = np.zeros((n, W), dtype=data.dtype)
    if len(indices):
        rows = np.repeat(np.arange(n), row_nnz)
        offs = np.arange(len(indices)) - np.repeat(indptr[:-1], row_nnz)
        cols[rows, offs] = indices
        vals[rows, offs] = data
    return ELL(cols, vals, row_nnz, (int(shape[0]), int(shape[1])))


def from_scipy(A, width=None):
    """scipy sparse -> host ELL, or a host BELL for a BSR matrix with
    blocks larger than 1 x 1."""
    import scipy.sparse as sp
    if sp.issparse(A) and A.format == "bsr" and A.blocksize != (1, 1):
        return bell_from_scipy(A, width=width)
    A = sp.csr_matrix(A) if not (sp.issparse(A) and A.format == "csr") \
        else A
    A = A.copy()
    A.sort_indices()
    return ell_from_csr_arrays(A.indptr, A.indices, A.data, A.shape, width)


def bell_from_scipy(A, width=None) -> BELL:
    """scipy sparse (as BSR, its blocksize kept) -> host BELL."""
    import scipy.sparse as sp
    A = sp.bsr_matrix(A) if not (sp.issparse(A) and A.format == "bsr") \
        else A
    A = A.copy()
    A.sort_indices()
    br, bc = A.blocksize
    nb = A.shape[0] // br
    indptr, indices, data = A.indptr, A.indices, A.data
    row_nnz = np.diff(indptr).astype(np.int32)
    W = int(max(1, row_nnz.max() if nb else 0)) if width is None \
        else int(width)
    cols = np.zeros((nb, W), dtype=np.int32)
    vals = np.zeros((nb, W, br, bc), dtype=data.dtype)
    if len(indices):
        rows = np.repeat(np.arange(nb), row_nnz)
        offs = np.arange(len(indices)) - np.repeat(indptr[:-1], row_nnz)
        cols[rows, offs] = indices
        vals[rows, offs] = data
    return BELL(cols, vals, row_nnz, (int(A.shape[0]), int(A.shape[1])),
                (int(br), int(bc)))


def to_scipy(A):
    """Host ELL/DIA -> scipy CSR; host BELL -> scipy BSR."""
    import scipy.sparse as sp
    if isinstance(A, DIA):
        n = A.shape[0]
        data = np.asarray(A.data)[:, :n]
        M = sp.dia_matrix((np.stack([np.roll(data[d], off)
                                     for d, off in enumerate(A.offsets)]),
                           np.asarray(A.offsets)), shape=A.shape).tocsr()
        M.eliminate_zeros()
        return M
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    row_nnz = np.asarray(A.row_nnz)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    mask = np.arange(A.width)[None, :] < row_nnz[:, None]
    if isinstance(A, BELL):
        return sp.bsr_matrix((vals[mask], cols[mask], indptr), shape=A.shape,
                             blocksize=A.blocksize)
    return sp.csr_matrix((vals[mask], cols[mask], indptr), shape=A.shape)


def ell_from_dia(A: DIA) -> ELL:
    """A DIA (host or placed) back to a host ELL, its zeros dropped."""
    data = A.data.cpu().numpy() if isinstance(A.data, torch.Tensor) \
        else A.data
    return from_scipy(to_scipy(DIA(data, A.offsets, A.shape)))


def eye(n, dtype=np.float32, width: int = 1) -> ELL:
    """The identity as a host ELL of ``width`` slots a row."""
    cols = np.zeros((n, width), dtype=np.int32)
    cols[:, 0] = np.arange(n, dtype=np.int32)
    vals = np.zeros((n, width), dtype=dtype)
    vals[:, 0] = 1
    return ELL(cols, vals, np.ones((n,), np.int32), (n, n))


def ell_from_coo(rows, cols, vals, shape, width=None, sum_duplicates=True,
                 min_width: int = 1) -> ELL:
    """A host ELL from COO triplets (numpy or tensors) of equal length:
    entries with ``rows == shape[0]`` are padding and dropped, the rest
    sorted by (row, column) and, with ``sum_duplicates``, coalesced."""
    def np_(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)
    n = int(shape[0])
    r, c, v = np_(rows), np_(cols), np_(vals)
    keep = r < n
    r, c, v = r[keep], c[keep], v[keep]
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    if sum_duplicates and len(r):
        key = r.astype(np.int64) * np.int64(shape[1] + 1) + c
        head = np.concatenate([[True], key[1:] != key[:-1]])
        seg = np.cumsum(head) - 1
        if np.iscomplexobj(v):
            v = np.bincount(seg, weights=v.real) + \
                1j * np.bincount(seg, weights=v.imag)
        else:
            v = np.bincount(seg, weights=v).astype(v.dtype)
        r, c = r[head], c[head]
    counts = np.bincount(r, minlength=n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)])
    return ell_from_csr_arrays(indptr, c, v, shape, width=width,
                               min_width=min_width)


def asarray_or_ell(A, dtype=None):
    """Accept scipy / dense / ELL / BELL inputs uniformly (user-facing
    factories): a BSR matrix becomes a BELL, anything else an ELL."""
    import scipy.sparse as sp
    if not isinstance(A, (ELL, BELL)):
        A = from_scipy(A if sp.issparse(A) else sp.csr_matrix(np.asarray(A)))
    return A if dtype is None else A.astype(dtype)
