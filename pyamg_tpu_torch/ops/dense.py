"""Densify a sparse container and invert it (counterpart of
``pyamg_tpu/ops/dense.py:inv_device_checked``).

Used once at setup, by ``MultilevelSolver.collapse_coarse``, for the
coarse level that becomes a dense inverse.  The inverse is a library call
(``torch.linalg.inv``), as ``jnp.linalg.inv`` was in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pyamg_tpu_torch._device import as_tensor, resolve
from pyamg_tpu_torch.sparse.matrix import BELL, DIA, ELL, to_scipy
from pyamg_tpu_torch.sparse.sell import SELL, sell_to_scipy


def check_matmul_precision():
    """Raise unless float32 matrix products run in full float32: a TF32
    product (3 decimal digits) would spoil the coarse inverse, its 1e-2
    accuracy probe and every dense coarse solve."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmuls must run in full precision: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def to_dense(A, device="cuda") -> torch.Tensor:
    """Dense (n, m) tensor of a host DIA, ELL, BELL or SELL container on
    ``device``."""
    device = resolve(device)
    n, m = A.shape
    if isinstance(A, DIA):
        data = as_tensor(np.asarray(A.data)[:, :n], device)
        M = torch.zeros((n, m), dtype=data.dtype, device=device)
        rows = torch.arange(n, device=device)
        for d, off in enumerate(A.offsets):
            cols = rows + off
            ok = (cols >= 0) & (cols < m)
            M.index_put_((rows[ok], cols[ok]), data[d][ok], accumulate=True)
        return M
    if isinstance(A, ELL):
        valid = A.valid_mask()
        rows = np.broadcast_to(np.arange(n)[:, None], valid.shape)
        vals = as_tensor(np.asarray(A.vals)[valid], device)
        M = torch.zeros((n, m), dtype=vals.dtype, device=device)
        M.index_put_((as_tensor(rows[valid], device, torch.long),
                      as_tensor(np.asarray(A.cols)[valid], device,
                                torch.long)),
                     vals, accumulate=True)
        return M
    if isinstance(A, SELL):
        return as_tensor(sell_to_scipy(A).toarray(), device)
    if isinstance(A, BELL):
        return as_tensor(to_scipy(A).toarray(), device)
    raise TypeError(f"cannot densify {type(A).__name__}")


def inv_device(A, device="cuda"):
    """The dense inverse of a host container, computed on ``device``."""
    return torch.linalg.inv(to_dense(A, device))


def inv_device_checked(A, device="cuda"):
    """(inverse, max |M @ inv - I|, dense M), all on ``device``."""
    check_matmul_precision()
    M = to_dense(A, device)
    op = torch.linalg.inv(M)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    err = torch.abs(M @ op - eye).max()
    return op, err, M
