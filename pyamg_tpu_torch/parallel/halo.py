"""Static halo-exchange plans for the row-sharded SpMV (counterpart of
``pyamg_tpu/parallel/halo.py``).

Setup (host, numpy)
    The rows and columns of a level operator are split into contiguous
    blocks over the ranks (``n_loc = n_pad / ndev`` rows each).  For every
    pair of ranks with a coupling the plan records which x entries must
    move: one gather list per ring offset.  AMG levels keep the grid's
    locality, so contiguous row blocks couple almost only to their ring
    neighbours, and the exchange is a few messages of a grid line each
    rather than an all-gather of the whole vector.  ``build_halo_plan``
    builds the plan of every rank; ``build_halo`` keeps this rank's part.

Solve (device)
    ``HaloELL.mv`` gathers one send buffer per ring offset
    (``halo_send``), exchanges them all in one ``batch_isend_irecv`` (to
    rank ``r + o``, from rank ``r - o``, as the reference's ``ppermute``
    does), and computes the local product on ``[x_local | segments]``
    (``halo_local_mv``), whose columns were remapped to that local index
    space at setup.  The two plain functions take local tensors only, so
    one process can run every rank's step in a loop.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from pyamg_tpu_torch._device import as_tensor
from pyamg_tpu_torch.parallel.partition import (RowMesh, RowSharded, count,
                                                _ell_mv, host_ell)
from pyamg_tpu_torch.sparse.matrix import ELL


@dataclasses.dataclass(frozen=True, eq=False)
class HaloPlan:
    """The halo plan of every rank, host arrays.

    cols      -- (ndev, n_loc, W) int32 local column indices: values in
                 ``[0, m_loc)`` address the rank's own x block, values in
                 ``[m_loc, m_loc + H)`` the received segments laid end to
                 end in offset order.  Padding slots point at 0.
    vals      -- (ndev, n_loc, W) values (0 in padding slots).
    send_idx  -- one (ndev, S_o) int32 array per ring offset ``o``: row e
                 holds the local x indices rank e sends to rank
                 ``(e + o) % ndev`` (padded by repeating index 0; the
                 receiver never reads the padded slots).
    offsets   -- ring offsets with any traffic.
    seg_sizes -- padded receive-segment length per offset.
    shape     -- padded global (n_pad, m_pad).
    """

    cols: np.ndarray
    vals: np.ndarray
    send_idx: Tuple[np.ndarray, ...]
    offsets: Tuple[int, ...]
    seg_sizes: Tuple[int, ...]
    shape: Tuple[int, int]
    n_loc: int
    m_loc: int
    nnz: int

    @property
    def ndev(self) -> int:
        return self.cols.shape[0]


def _pad_to(n: int, multiple: int) -> int:
    return n + ((-n) % multiple)


def build_halo_plan(A: ELL, ndev: int, identity_pad=None) -> HaloPlan:
    """The halo plan of every one of ``ndev`` ranks for a host (or placed)
    ELL: rows (and the columns of a square operator) padded to a multiple
    of ``ndev``, square operators with unit-diagonal pad rows
    (``identity_pad`` defaults to whether A is square), rows split into
    contiguous blocks, the send lists per ring offset, and the columns
    remapped to each rank's local + halo index space."""
    A = host_ell(A)
    cols, vals, rn = A.cols, A.vals, A.row_nnz
    n, m = A.shape
    square = n == m
    if identity_pad is None:
        identity_pad = square
    n_pad = _pad_to(n, ndev)
    m_pad = n_pad if square else _pad_to(m, ndev)
    n_loc, m_loc = n_pad // ndev, m_pad // ndev
    W = cols.shape[1]
    if n_pad > n:
        pc = np.zeros((n_pad - n, W), np.int32)
        pv = np.zeros((n_pad - n, W), vals.dtype)
        prn = np.zeros((n_pad - n,), np.int32)
        if identity_pad and square:
            pc[:, 0] = n + np.arange(n_pad - n)
            pv[:, 0] = 1
            prn[:] = 1
        cols = np.concatenate([cols, pc])
        vals = np.concatenate([vals, pv])
        rn = np.concatenate([rn, prn])
    # padding slots generate no traffic
    slot = np.arange(W)[None, :] < rn[:, None]
    cols_eff = np.where(slot, cols, 0)

    # need[d][e]: the sorted global columns rank d reads from rank e
    need = [[None] * ndev for _ in range(ndev)]
    for d in range(ndev):
        blk = slice(d * n_loc, (d + 1) * n_loc)
        c = cols_eff[blk][slot[blk]]
        remote = c[c // m_loc != d]
        owner = remote // m_loc
        for e in np.unique(owner):
            need[d][int(e)] = np.unique(remote[owner == e])

    offsets, seg_sizes, send_idx = [], [], []
    for o in range(1, ndev):
        sizes = [0 if need[d][(d - o) % ndev] is None
                 else len(need[d][(d - o) % ndev]) for d in range(ndev)]
        S = max(sizes)
        if S == 0:
            continue
        offsets.append(o)
        seg_sizes.append(S)
        sidx = np.zeros((ndev, S), np.int32)
        for e in range(ndev):                    # e sends to (e + o) % ndev
            lst = need[(e + o) % ndev][e]
            if lst is not None:
                sidx[e, :len(lst)] = lst - e * m_loc
        send_idx.append(sidx)

    new_cols = np.zeros_like(cols)
    for d in range(ndev):
        blk = slice(d * n_loc, (d + 1) * n_loc)
        lut = np.zeros((m_pad,), np.int64)      # global column -> local
        lut[d * m_loc:(d + 1) * m_loc] = np.arange(m_loc)
        base = m_loc
        for o, S in zip(offsets, seg_sizes):
            lst = need[d][(d - o) % ndev]
            if lst is not None:
                lut[lst] = base + np.arange(len(lst))
            base += S
        new_cols[blk] = lut[cols_eff[blk]]
    new_cols = np.where(slot, new_cols, 0).astype(np.int32)
    return HaloPlan(
        cols=new_cols.reshape(ndev, n_loc, W),
        vals=np.where(slot, vals, 0).reshape(ndev, n_loc, W),
        send_idx=tuple(send_idx), offsets=tuple(offsets),
        seg_sizes=tuple(seg_sizes), shape=(n_pad, m_pad), n_loc=n_loc,
        m_loc=m_loc, nnz=int(rn.sum()))


def halo_send(x_local, send_idx):
    """The send buffers of one rank: ``x_local[send_idx[o]]`` per offset
    (rows of a 2-D x)."""
    return [x_local[s] for s in send_idx]


def halo_local_mv(cols, vals, x_local, segments):
    """One rank's rows of A x from its own block of x and the segments it
    received, in offset order."""
    xfull = torch.cat([x_local] + list(segments)) if segments else x_local
    return _ell_mv(cols, vals, xfull)


def exchange(buffers, offsets, seg_sizes, mesh: RowMesh):
    """Send ``buffers[k]`` to rank ``r + offsets[k]`` and receive a
    segment of ``seg_sizes[k]`` rows from rank ``r - offsets[k]``, all in
    one ``batch_isend_irecv``; returns the received segments."""
    ops, segs = [], []
    r, p = mesh.rank, mesh.size
    for o, S, buf in zip(offsets, seg_sizes, buffers):
        seg = buf.new_empty((S,) + tuple(buf.shape[1:]))
        ops.append(dist.P2POp(dist.isend, buf, mesh.ranks[(r + o) % p],
                              mesh.group))
        ops.append(dist.P2POp(dist.irecv, seg, mesh.ranks[(r - o) % p],
                              mesh.group))
        segs.append(seg)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        count("send", len(segs))
        count("recv", len(segs))
    return segs


@dataclasses.dataclass(frozen=True, eq=False)
class HaloELL(RowSharded):
    """This rank's part of a ``HaloPlan`` on ``mesh.device``: ``cols`` and
    ``vals`` (n_loc, W) in the local + halo index space, ``send_idx`` one
    (S_o,) index tensor per offset.  Input and output are split by rows
    (``n_loc`` and ``m_loc`` a rank)."""

    cols: torch.Tensor
    vals: torch.Tensor
    send_idx: Tuple[torch.Tensor, ...]
    offsets: Tuple[int, ...]
    seg_sizes: Tuple[int, ...]
    shape: Tuple[int, int]
    n_loc: int
    m_loc: int
    mesh: RowMesh
    _nnz: int = 0

    in_sharded = True
    out_sharded = True

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def ndev(self) -> int:
        return self.mesh.size

    @property
    def nnz(self) -> int:
        return self._nnz

    def halo_width(self) -> int:
        return int(sum(self.seg_sizes))

    def mv(self, x):
        """This rank's rows of A x from its block ``x`` ((m_loc,) or
        (m_loc, k): one exchange of (S_o, k) buffers)."""
        segs = exchange(halo_send(x, self.send_idx), self.offsets,
                        self.seg_sizes, self.mesh)
        return halo_local_mv(self.cols, self.vals, x, segs)

    __matmul__ = mv

    def rmatvec(self, v):
        """This rank's block of Aᴴ v: the rank's rows' part over its local
        + halo index space, whose halo segments go back to their owners
        (the exchange reversed) and are added at the rows they were sent
        from."""
        out = torch.zeros((self.m_loc + self.halo_width(),) +
                          tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        out.index_add_(0, self.cols.reshape(-1),
                       (self.vals.conj() * v[:, None]).reshape(-1))
        segs, base = [], self.m_loc
        for S in self.seg_sizes:
            segs.append(out[base:base + S])
            base += S
        back = exchange(segs, tuple(-o for o in self.offsets),
                        tuple(s.shape[0] for s in self.send_idx), self.mesh)
        y = out[:self.m_loc].clone()
        for idx, seg in zip(self.send_idx, back):
            y.index_add_(0, idx, seg)
        return y

    def diagonal(self):
        return extract_diagonal_halo(self)

    def __repr__(self):
        return (f"HaloELL(shape={self.shape}, rank={self.mesh.rank}/"
                f"{self.mesh.size}, offsets={self.offsets}, "
                f"halo={self.halo_width()}, dtype={self.dtype})")


def build_halo(A: ELL, mesh: RowMesh, identity_pad=None) -> HaloELL:
    """This rank's ``HaloELL`` of a host (or placed) ELL: the plan of
    every rank is built on the host (``build_halo_plan``) and the rank's
    part placed on ``mesh.device``."""
    plan = build_halo_plan(A, mesh.size, identity_pad)
    r, dev = mesh.rank, mesh.device
    return HaloELL(
        cols=as_tensor(plan.cols[r], dev, torch.long),
        vals=as_tensor(plan.vals[r], dev),
        send_idx=tuple(as_tensor(s[r], dev, torch.long)
                       for s in plan.send_idx),
        offsets=plan.offsets, seg_sizes=plan.seg_sizes, shape=plan.shape,
        n_loc=plan.n_loc, m_loc=plan.m_loc, mesh=mesh, _nnz=plan.nnz)


def extract_diagonal_halo(H: HaloELL):
    """This rank's block of diag(A) of a square ``HaloELL`` (a padded row
    reads 1)."""
    if H.shape[0] != H.shape[1]:
        raise ValueError("the diagonal of a non-square operator")
    loc = torch.arange(H.n_loc, device=H.cols.device)
    return torch.sum(torch.where(H.cols == loc[:, None], H.vals, 0), dim=1)
