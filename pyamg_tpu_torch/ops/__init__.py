"""Compute over the port's sparse containers: host (numpy/scipy) setup
ops, solve-phase products, and the CUDA kernels of ``dia_kernels`` and
``sell_kernels`` (counterpart of ``pyamg_tpu/ops``)."""

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import BELL, ELL
from pyamg_tpu_torch.ops.spmv import (
    bspmv, extract_block_diagonal, extract_diagonal, matvec,
    row_max_abs_offdiag, rspmv, spmv)
from pyamg_tpu_torch.ops.spgemm import masked_spgemm, spgemm, spgemm_bell
from pyamg_tpu_torch.ops.transpose import btranspose, transpose
from pyamg_tpu_torch.ops.arith import (
    add, add_scaled_identity, filter_rows_by_mask, remove_diagonal, scale,
    scale_cols, scale_rows, sub, with_diagonal)
from pyamg_tpu_torch.ops.rowops import (dedup_rows, drop_explicit_zeros,
                                        ell_dedup)


def matmul(A, B):
    """sparse @ sparse -> sparse (host), sparse @ dense -> dense."""
    dense = B if isinstance(B, torch.Tensor) else np.asarray(B)
    if isinstance(A, ELL):
        if isinstance(B, ELL):
            return spgemm(A, B)
        if isinstance(B, BELL):
            raise TypeError("ELL @ BELL is not supported; convert first")
        return spmv(A, dense)
    if isinstance(A, BELL):
        if isinstance(B, BELL):
            return spgemm_bell(A, B)
        if isinstance(B, ELL):
            raise TypeError("BELL @ ELL is not supported; convert first")
        return bspmv(A, dense)
    raise TypeError(type(A))


__all__ = [
    "spmv", "bspmv", "matvec", "rspmv", "extract_diagonal",
    "extract_block_diagonal", "row_max_abs_offdiag", "spgemm", "spgemm_bell",
    "masked_spgemm", "transpose", "btranspose", "scale", "scale_rows",
    "scale_cols", "add", "sub", "add_scaled_identity", "with_diagonal",
    "remove_diagonal", "filter_rows_by_mask", "dedup_rows", "ell_dedup",
    "drop_explicit_zeros", "matmul",
]
