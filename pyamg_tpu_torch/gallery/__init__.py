"""Model problems of the port."""

from pyamg_tpu_torch.gallery.advection import advection_2d
from pyamg_tpu_torch.gallery.laplacian import poisson
from pyamg_tpu_torch.gallery.stencil import stencil_grid

__all__ = ["advection_2d", "poisson", "stencil_grid"]
