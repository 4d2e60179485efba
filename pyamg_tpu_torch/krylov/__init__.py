"""Krylov methods of the port (counterpart of ``pyamg_tpu/krylov``)."""

from pyamg_tpu_torch.krylov.methods import (
    cg, bicgstab, cgne, cgnr, cr, minimal_residual, steepest_descent)
from pyamg_tpu_torch.krylov.gmres import (
    gmres, gmres_mgs, gmres_householder, fgmres)

__all__ = [
    "cg", "bicgstab", "cgne", "cgnr", "cr", "minimal_residual",
    "steepest_descent", "gmres", "gmres_mgs", "gmres_householder", "fgmres",
]
