"""Sparse containers and host converters of the port
(``sparse/matrix.py``; counterpart of ``pyamg_tpu/sparse``)."""

from pyamg_tpu_torch.sparse.matrix import (
    BELL, ELL, asarray_or_ell, bell_from_scipy, ell_from_coo,
    ell_from_csr_arrays, eye, from_scipy, to_scipy)

__all__ = [
    "ELL", "BELL", "from_scipy", "bell_from_scipy", "to_scipy",
    "ell_from_csr_arrays", "ell_from_coo", "eye", "asarray_or_ell",
]
