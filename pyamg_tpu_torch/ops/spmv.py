"""Sparse matrix-vector products (counterpart of ``pyamg_tpu/ops/spmv.py``).

Host (numpy) operands take scipy's CSR product: that is the setup phase.
Tensor operands are the solve phase: a DIA product is kernel K1 on CUDA
(``ops/dia_kernels.py``), a SELL product kernel K3/K4
(``ops/sell_kernels.py``), an ELL product a gather-multiply-reduce.
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import DIA, ELL, PhaseStencil, to_scipy
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.ops import dia_kernels, sell_kernels


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


def dia_spmv(A: DIA, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for banded A and x of shape (n,) or (n, k) (kernel K1 on
    CUDA tensors, one launch)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("dia_spmv takes a tensor")
    return dia_kernels.dia_spmv(A.data, A.offsets, A.shape[0], x)


def matvec(A, x):
    """Dispatch on container type."""
    if isinstance(A, DIA):
        return dia_spmv(A, x)
    if isinstance(A, PhaseStencil):
        return A.mv(x)
    if isinstance(A, SELL):
        return sell_kernels.sell_spmv(A, x)
    if isinstance(A, ELL):
        return spmv(A, x)
    raise TypeError(f"no matvec for {type(A).__name__}")


def extract_diagonal(A):
    """diag(A) as a dense vector of a DIA, a square SELL or an ELL."""
    if isinstance(A, (DIA, SELL)):
        return A.diagonal()
    if isinstance(A.cols, torch.Tensor):
        rows = torch.arange(A.shape[0], device=A.cols.device)[:, None]
        slots = torch.arange(A.width, device=A.cols.device)[None, :]
        hit = (A.cols == rows) & (slots < A.row_nnz[:, None])
        return torch.sum(torch.where(hit, A.vals, 0), dim=1)
    hit = (A.cols == np.arange(A.shape[0], dtype=np.int32)[:, None]) & \
        A.valid_mask()
    return np.sum(np.where(hit, A.vals, 0), axis=1)
