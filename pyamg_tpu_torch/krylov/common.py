"""Shared Krylov helpers (counterpart of ``dot``, ``norm`` and
``real_dtype`` in ``pyamg_tpu/krylov/common.py``)."""

from __future__ import annotations

import torch


def real_dtype(dtype):
    """The real dtype residual norms live in for value dtype ``dtype``."""
    return torch.empty((), dtype=dtype).real.dtype


def dot(a, b):
    """<conj(a), b>."""
    return torch.vdot(a, b)


def norm(v):
    return torch.sqrt(torch.real(torch.vdot(v, v)))
