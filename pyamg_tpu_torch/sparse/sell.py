"""SELL (shift-ELL): the layout of mildly unstructured operators (AMG coarse
levels and smoothed transfer operators), counterpart of
``pyamg_tpu/sparse/sell.py``.

Rows live in a padded ``(Sy, 128)`` layout: row ``i`` at sublane
``sigma = i // 128``.  Every stored entry ``A[i, c]`` is measured against
the anchor ``anchor(sigma)`` (``sigma // t`` for a tall operator with
integer row/column ratio ``t``, ``sigma * t`` for a fat one, ``sigma`` for
a square) and bucketed into passes: pass ``p`` has a window base
``bases[p]`` and holds at most one entry per row, at column

    c = 128 * (anchor(sigma) + bases[p]) + delta[p, i].

``sell_from_ell`` builds this plan on the host at setup, exactly as the
reference builds it: the plan decides which operators become SELL and so
which Gauss-Seidel runs, and the hybrid Gauss-Seidel iterate depends on it.
The SpMV is kernel K3/K4 and the sweep kernel K5
(``ops/sell_kernels.py``).  SELL is float32 only.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor

LANE = 128
TILE_SUBLANES = 8          # sublane granularity for padding / GS tiles

# Plan-shaping parity constants.  They are the TPU kernels' VMEM budgets
# (pyamg_tpu/ops/sell_kernels.py: _VMEM_X_BUDGET, _TILE_BLOCK_BUDGET and
# _pick_tile_rows), not limits of the H100, whose kernels read x from
# device memory at any size.  sell_from_ell keeps them so that it accepts
# and rejects the same operators as the reference and builds the same
# plans.
_VMEM_X_BUDGET = 6 * 1024 * 1024
_TILE_BLOCK_BUDGET = 6 * 1024 * 1024


def _pick_tile_rows(T, K, span, Sy):
    """The reference's row tile for its tiled square kernel (None: no tile
    fits its VMEM budget and covers the coupling span)."""
    for TRow in (512, 256, 128, 64, 32, 16, 8):
        if Sy % TRow != 0 or span > TRow:
            continue
        blk = 2 * T * TRow * LANE * 4 + 3 * TRow * LANE * 4
        if blk <= _TILE_BLOCK_BUDGET:
            return TRow
    return None


@dataclasses.dataclass(frozen=True)
class SELL:
    """Shift-ELL operator: a pass plan of windowed gathers.

    ``vals``/``delta`` are ``(T, Sy, 128)`` (float32 / int32), ``bases``
    the window base row of each pass, ``diag`` the main diagonal (square
    operators; else empty).  On the host they are numpy arrays; ``to``
    places them on a device and adds ``bases_t``, the bases as an int32
    tensor, made once so that no call copies them, and ``zero_delta0``:
    whether every slot holding 0 has delta 0 (the padded slots have; the
    SpMV kernel then skips the delta read of a slot holding 0)."""

    vals: object
    delta: object
    bases: Tuple[int, ...]
    diag: object
    shape: Tuple[int, int]
    t: int               # integer row/col ratio
    kind: str            # "tall" (n = t*m) or "fat" (m = t*n); square = tall/1
    K: int               # windows per pass (delta spans K*128)
    pad_top: int         # guard rows above x in the reference's x layout
    x_rows: int          # rows of the reference's padded x layout
    _nnz: int = 0
    base_lo: int = 0
    base_hi: int = 0
    bases_t: object = None
    zero_delta0: bool = False

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def blocksize(self) -> Tuple[int, int]:
        return (1, 1)

    @property
    def n_passes(self) -> int:
        return self.vals.shape[0]

    @property
    def Sy(self) -> int:
        return self.vals.shape[1]

    @property
    def Sx(self) -> int:
        return (self.Sy // self.t) if self.kind == "tall" else \
            self.Sy * self.t

    @property
    def square(self) -> bool:
        return self.kind == "tall" and self.t == 1

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def nnz(self) -> int:
        return self._nnz

    def mv(self, x):
        from pyamg_tpu_torch.ops.sell_kernels import sell_spmv
        return sell_spmv(self, x)

    __matmul__ = mv

    def diagonal(self):
        return self.diag

    def astype(self, dtype):
        """The plan with its values and diagonal in ``dtype`` (the SELL
        kernels take float32 only)."""
        from pyamg_tpu_torch.sparse.matrix import _astype
        return dataclasses.replace(self, vals=_astype(self.vals, dtype),
                                   diag=_astype(self.diag, dtype))

    def to(self, device) -> "SELL":
        vals = as_tensor(self.vals, device, torch.float32)
        delta = as_tensor(self.delta, device, torch.int32)
        return dataclasses.replace(
            self, vals=vals, delta=delta,
            diag=as_tensor(self.diag, device, torch.float32),
            bases_t=torch.tensor(self.bases, dtype=torch.int32,
                                 device=device),
            zero_delta0=not bool(((vals == 0) & (delta != 0)).any()))

    def __repr__(self):
        return (f"SELL(shape={self.shape}, passes={self.n_passes}, "
                f"K={self.K}, kind={self.kind}/{self.t}, "
                f"dtype={self.vals.dtype})")


def _roundup(a, b):
    return -(-a // b) * b


def sell_from_ell(A, max_passes=None, max_elems=2_500_000,
                  max_elems_square=40_000_000,
                  max_inflation=16.0, k_choices=(4, 8, 16)):
    """Build the SELL plan of a float32 host ELL; None if unsuitable (not
    float32, too large, or its offsets too scattered), by the reference's
    rules and with its arithmetic (setup phase)."""
    from pyamg_tpu_torch.sparse.matrix import ELL
    if not isinstance(A, ELL) or isinstance(A.cols, torch.Tensor):
        return None
    n, m = A.shape
    if n == 0 or m == 0:
        return None
    if np.dtype(A.vals.dtype) != np.float32:
        return None
    cap = max_elems_square if n == m else max_elems
    if max(n, m) > cap:
        return None

    # slot-wise work in the (n, W) ELL layout, int32 throughout (as the
    # reference: its plan must come out the same)
    cols2 = np.asarray(A.cols)
    vals2 = np.asarray(A.vals)
    W = int(cols2.shape[1])
    row_nnz = np.asarray(A.row_nnz)
    valid2 = np.arange(W, dtype=np.int32)[None, :] < row_nnz[:, None]
    nnz = int(row_nnz.sum())
    if nnz == 0:
        return None

    # --- integer-ratio padding -------------------------------------------
    if n >= m:
        kind = "tall"
        t = max(1, int(round(n / m)))
        Sx = _roundup(max(m, -(-n // t)), LANE) // LANE
        g = np.gcd(t, TILE_SUBLANES)
        Sx = _roundup(Sx, TILE_SUBLANES // g)
        if t == 1 and Sx >= 512:
            Sx = _roundup(Sx, 512)
        Sy = t * Sx
    else:
        kind = "fat"
        t = max(1, int(round(m / n)))
        Sy = _roundup(max(n, -(-m // t)), LANE) // LANE
        Sy = _roundup(Sy, TILE_SUBLANES)
        Sx = t * Sy

    rows32 = np.arange(n, dtype=np.int32)
    if kind == "tall":
        anchor_r = (rows32 >> 7) // t if t > 1 else (rows32 >> 7)
    else:
        anchor_r = (rows32 >> 7) * np.int32(t)

    delta_abs2 = cols2.astype(np.int32, copy=False) - \
        (anchor_r[:, None] << 7)                       # (n, W)
    w2 = delta_abs2 >> 7                 # window row (arith shift = floor)
    wv = w2[valid2]
    wmin = int(wv.min())
    wmax = int(wv.max())
    if wmax - wmin <= 4_000_000:
        uw = np.flatnonzero(np.bincount(wv - wmin)) + wmin
    else:
        uw = np.unique(wv)
    del wv
    # padding slots may fall outside the valid window range: clip so the
    # group lookup stays in bounds (they go to a sentinel group below)
    w2 = np.clip(w2, wmin, wmax)
    if max_passes is None:
        max_passes = max(512, 4_000_000 // (Sy * LANE))

    slotwise = W * W * n <= 2_000_000_000

    # --- choose K and cluster windows into passes -------------------------
    best = None
    for K in k_choices:
        bases_list = []
        start = uw[0]
        for u in uw:
            if u - start >= K:
                bases_list.append(start)
                start = u
        bases_list.append(int(start))
        bases_arr = np.asarray(bases_list, np.int64)
        G = len(bases_arr)
        lut = (np.searchsorted(bases_arr, np.arange(wmin, wmax + 1),
                               side="right") - 1).astype(np.int32)
        gidx2 = np.where(valid2, lut[w2 - wmin], np.int32(G))  # (n, W)
        # depth = per-(row, group) count of earlier slots, in slot order
        depth2 = np.zeros((n, W), np.int32)
        if slotwise:
            for k in range(1, W):
                eq = gidx2[:, :k] == gidx2[:, k:k + 1]
                depth2[:, k] = eq.sum(axis=1, dtype=np.int32)
        else:
            ii, kk = np.nonzero(valid2)
            key = gidx2[ii, kk].astype(np.int64) * n + ii
            order = np.argsort(key, kind="stable")
            ks = key[order]
            head = np.concatenate([[True], ks[1:] != ks[:-1]])
            run_id = np.cumsum(head) - 1
            run_start = np.nonzero(head)[0]
            d = np.arange(len(ks)) - run_start[run_id]
            dsc = np.empty(len(ks), np.int64)
            dsc[order] = d
            depth2[ii, kk] = dsc
        # pass widths per group: 1 + deepest occupied slot
        code = gidx2 * np.int32(W) + depth2
        cnts = np.bincount(code.ravel(), minlength=(G + 1) * W)
        occ = cnts[:G * W].reshape(G, W) > 0
        anyocc = occ.any(axis=1)
        gw = np.where(anyocc, W - np.argmax(occ[:, ::-1], axis=1), 0)
        T = int(gw.sum())
        cost = T * (8 + K)
        if T <= max_passes and (best is None or cost < best[0]):
            best = (cost, K, bases_arr, gidx2, depth2, gw, T)
    if best is None:
        return None
    _, K, bases_arr, gidx2, depth2, gw, T = best
    slots = T * Sy * LANE
    if slots > max_inflation * nnz and slots > 262144:
        return None

    # --- fill pass arrays --------------------------------------------------
    goff = np.concatenate([[0], np.cumsum(gw)]).astype(np.int32)
    bases32 = np.append(bases_arr.astype(np.int32), 0)  # sentinel slot
    p2 = goff[gidx2] + depth2                  # (n, W) pass index
    dloc2 = delta_abs2 - (bases32[gidx2] << 7)
    vals_t = np.zeros((T, Sy * LANE), np.float32)
    delta_t = np.zeros((T, Sy * LANE), np.int32)
    for k in range(W):
        mk = valid2[:, k]
        pk = p2[:, k]
        # dominant pass of the slot: one boolean row assignment, then a
        # small scatter for the rows that differ
        pc = int(pk[n // 2])
        cm = mk & (pk == pc)
        if pc < T:
            vals_t[pc, :n][cm] = vals2[cm, k]
            delta_t[pc, :n][cm] = dloc2[cm, k]
            rest = mk & ~cm
        else:
            rest = mk
        if rest.any():
            ri = rows32[rest]
            vals_t[pk[rest], ri] = vals2[rest, k]
            delta_t[pk[rest], ri] = dloc2[rest, k]
    pass_base = np.repeat(bases_arr.astype(np.int32), gw)

    # --- guard extents of the reference's x layout --------------------------
    min_b = int(pass_base.min())
    max_b = int(pass_base.max())
    if kind == "tall":
        pad_top = _roundup(max(0, -t * min_b), TILE_SUBLANES)
        x_rows = _roundup(pad_top + t * max(0, max_b + K - 1) + Sy,
                          TILE_SUBLANES) + TILE_SUBLANES
    else:
        pad_top = _roundup(max(0, -min_b), TILE_SUBLANES)
        x_rows = _roundup(pad_top + max(0, max_b + K - 1) + Sx,
                          TILE_SUBLANES) + TILE_SUBLANES

    # --- the reference's kernel feasibility rule (parity constants above)
    if x_rows * LANE * 4 > _VMEM_X_BUDGET:
        if not (kind == "tall" and t == 1):
            return None
        span = max_b - min_b + K - 1
        if _pick_tile_rows(T, K, span, Sy) is None:
            return None

    if kind == "tall" and t == 1:
        dg = np.zeros((n,), np.float32)
        for k in range(W):
            hit = valid2[:, k] & (cols2[:, k] == rows32)
            dg += np.where(hit, vals2[:, k], 0).astype(np.float32)
    else:
        dg = np.zeros((0,), np.float32)

    return SELL(vals=vals_t.reshape(T, Sy, LANE),
                delta=delta_t.reshape(T, Sy, LANE),
                bases=tuple(int(b) for b in pass_base),
                diag=dg,
                shape=(int(n), int(m)),
                t=int(t), kind=kind, K=int(K),
                pad_top=int(pad_top), x_rows=int(x_rows),
                _nnz=nnz,
                base_lo=int(min_b), base_hi=int(max_b))


def sell_to_scipy(A: SELL):
    """The scipy CSR matrix a host plan describes."""
    import scipy.sparse as sp
    T, Sy, _ = A.vals.shape
    rows = np.arange(Sy * LANE, dtype=np.int64)
    sigma = rows // LANE
    anchor = sigma // A.t if A.kind == "tall" else sigma * A.t
    cols = LANE * (anchor[None, :] + np.asarray(A.bases, np.int64)[:, None]) \
        + np.asarray(A.delta).reshape(T, Sy * LANE)
    rows = np.broadcast_to(rows, cols.shape)
    vals = np.asarray(A.vals).reshape(T, Sy * LANE)
    n, m = A.shape
    keep = (vals != 0) & (rows < n) & (cols >= 0) & (cols < m)
    return sp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                         shape=(n, m))
