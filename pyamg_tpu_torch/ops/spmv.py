"""Sparse matrix-vector products (counterpart of ``pyamg_tpu/ops/spmv.py``).

Host (numpy) operands take scipy's CSR product: that is the setup phase.
Tensor operands are the solve phase: a DIA product is kernel K1 on CUDA
(``ops/dia_kernels.py``), a SELL product kernel K3/K4
(``ops/sell_kernels.py``), an ELL product a gather-multiply-reduce, a BELL
product with a vector kernel K7 (``ops/bell_kernels.py``: one launch over
the BELL's block layout, the residual ``b - A x`` fused into it by
``residual``; on CPU tensors its plain version), and a BELL product with
several vectors a gather of x's blocks and one einsum (the reference
computes both as that einsum, outside any Pallas kernel).  Block products
are counted in the store by their shape, on every replay of a captured
graph.  A row-sharded operator (``parallel``) computes its rank's rows,
gathering or exchanging its input across the ranks first.
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import (BELL, DIA, ELL, PhaseStencil,
                                           to_scipy)
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops import (bell_kernels, dia_kernels, launch,
                                 sell_kernels)
from pyamg_tpu_torch.ops.bell_kernels import count_bell_products
from pyamg_tpu_torch.parallel.partition import RowSharded


def _scipy_memo(A):
    """Cached scipy view of a host container (setup phase)."""
    S = getattr(A, "_scipy_view", None)
    if S is None:
        S = to_scipy(A)
        object.__setattr__(A, "_scipy_view", S)
    return S


def spmv(A: ELL, x):
    """y = A @ x for ELL A: scipy's product for host arrays (x of shape
    (n_cols,) or (n_cols, k)), a gather-multiply-reduce for a 1-D
    tensor."""
    if isinstance(x, np.ndarray):
        return _scipy_memo(A) @ x
    return torch.sum(A.vals * x[A.cols], dim=1)


def rspmv(A: ELL, x):
    """y = A^T x without building the transpose: scipy's product for host
    arrays, a scatter-add of ``vals * x[:, None]`` into the columns for a
    1-D tensor."""
    if isinstance(x, np.ndarray):
        return _scipy_memo(A).T @ x
    contrib = A.vals * x[:, None]
    return torch.zeros((A.shape[1],), dtype=contrib.dtype,
                       device=x.device).index_add_(
        0, A.cols.reshape(-1).long(), contrib.reshape(-1))


def row_max_abs_offdiag(A: ELL):
    """max_k |A[i, k]| over the stored off-diagonal entries of each row
    (0 where there is none), in A's array kind."""
    if isinstance(A.vals, torch.Tensor):
        rows = torch.arange(A.shape[0], device=A.vals.device)
        slots = torch.arange(A.width, device=A.vals.device)
        offd = (A.cols != rows[:, None]) & \
            (slots[None, :] < A.row_nnz[:, None])
        return torch.max(torch.where(offd, torch.abs(A.vals), 0), dim=1).values
    offd = (A.cols != np.arange(A.shape[0])[:, None]) & A.valid_mask()
    return np.max(np.where(offd, np.abs(A.vals), 0), axis=1)


def on_bell_kernel(A, x):
    """Whether a block product of A with x is K7's: a BELL of float32 or
    float64 tensors and a vector (K7 takes no complex blocks and one
    vector a launch)."""
    return isinstance(A, BELL) and isinstance(x, torch.Tensor) and \
        x.ndim == 1 and A.vals.dtype in bell_kernels.FLOATS


def bspmv(A: BELL, x):
    """y = A @ x for block-ELL A; x flat of shape (n_cols,) or (n_cols, k):
    scipy's BSR product for host arrays; for a vector K7 (mode apply, over
    A's layout, ``bell_kernels.layout_of``); else x's blocks gathered by
    block column and contracted with the blocks in one einsum."""
    if isinstance(x, np.ndarray):
        return _scipy_memo(A) @ x
    if on_bell_kernel(A, x):
        return bell_kernels.bell_apply(bell_kernels.layout_of(A),
                                       x.contiguous())
    if x.is_cuda:
        from pyamg_tpu_torch.ops.dense import check_matmul_precision
        check_matmul_precision()
    br, bc = A.blocksize
    nb, nbc = A.n_block_rows, A.n_block_cols
    launch.tally(count_bell_products,
                 (nb, nbc, br, bc, A.width, A.vals.element_size()))
    if x.ndim == 1:
        xg = x.reshape(nbc, bc)[A.cols]                 # (nb, W, bc)
        return torch.einsum("nwij,nwj->ni", A.vals, xg).reshape(nb * br)
    k = x.shape[1]
    xg = x.reshape(nbc, bc, k)[A.cols]                  # (nb, W, bc, k)
    return torch.einsum("nwij,nwjk->nik", A.vals, xg).reshape(nb * br, k)


def residual(A, x, b):
    """b - A @ x: one K7 launch (mode residual) for a BELL and vectors on
    which it runs (``on_bell_kernel``), else ``b - matvec(A, x)``."""
    if on_bell_kernel(A, x) and isinstance(b, torch.Tensor):
        return bell_kernels.bell_apply(bell_kernels.layout_of(A),
                                       x.contiguous(), "residual",
                                       b=b.contiguous())
    return b - matvec(A, x)


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for banded A and x of shape (n,) or (n, k) (kernel K1 on
    CUDA tensors, one launch).  A complex band, which K1 does not take,
    is torch operations, as the reference computes it with jnp where its
    kernel takes no such dtype (``pallas_kernels.py:116-118``)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("dia_spmv takes a tensor")
    if A.data.is_complex():
        return dia_kernels.dia_spmv_plain(A.data, A.offsets, A.shape[0], x)
    return dia_kernels.dia_spmv(A.data, A.offsets, A.shape[0], x)


def matvec(A, x):
    """Dispatch on container type."""
    if isinstance(A, DIA):
        return dia_spmv(A, x)
    if isinstance(A, BELL):
        return bspmv(A, x)
    if isinstance(A, PhaseStencil):
        return A.mv(x)
    if isinstance(A, SELL):
        return sell_kernels.sell_spmv(A, x)
    if isinstance(A, ELL):
        return spmv(A, x)
    if isinstance(A, RowSharded):
        return A.mv(x)
    raise TypeError(f"no matvec for {type(A).__name__}")


def _diagonal_blocks(A):
    """(nb, W) mask of the stored diagonal blocks of a square-blocked
    BELL (numpy or tensor, as A's arrays)."""
    if isinstance(A.cols, torch.Tensor):
        rows = torch.arange(A.n_block_rows, device=A.cols.device)[:, None]
        slots = torch.arange(A.width, device=A.cols.device)[None, :]
        return (A.cols == rows) & (slots < A.row_nnz[:, None])
    return (A.cols == np.arange(A.n_block_rows, dtype=np.int32)[:, None]) \
        & A.valid_mask()


def extract_block_diagonal(A: BELL):
    """(nb, br, bc) diagonal blocks of A (zero where none is stored)."""
    hit = _diagonal_blocks(A)
    if isinstance(hit, torch.Tensor):
        return torch.einsum("nw,nwij->nij", hit.to(A.vals.dtype), A.vals)
    return np.einsum("nw,nwij->nij", hit.astype(A.vals.dtype), A.vals)


def extract_diagonal(A):
    """diag(A) as a dense vector of a DIA, a square SELL, an ELL or a
    BELL with square blocks (of a row-sharded operator: the rank's
    block)."""
    if isinstance(A, (DIA, SELL, RowSharded)):
        return A.diagonal()
    if isinstance(A, BELL):
        br, bc = A.blocksize
        if br != bc:
            raise ValueError(f"the diagonal of blocks {A.blocksize} is not "
                             f"a scalar diagonal")
        D = extract_block_diagonal(A)
        if isinstance(D, torch.Tensor):
            return torch.diagonal(D, dim1=1, dim2=2).reshape(-1)
        idx = np.arange(br)
        return D[:, idx, idx].reshape(-1)
    if isinstance(A.cols, torch.Tensor):
        rows = torch.arange(A.shape[0], device=A.cols.device)[:, None]
        slots = torch.arange(A.width, device=A.cols.device)[None, :]
        hit = (A.cols == rows) & (slots < A.row_nnz[:, None])
        return torch.sum(torch.where(hit, A.vals, 0), dim=1)
    hit = (A.cols == np.arange(A.shape[0], dtype=np.int32)[:, None]) & \
        A.valid_mask()
    return np.sum(np.where(hit, A.vals, 0), axis=1)
