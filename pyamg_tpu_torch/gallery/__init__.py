"""Model problems of the port."""

from pyamg_tpu_torch.gallery.advection import advection_2d
from pyamg_tpu_torch.gallery.diffusion import (diffusion_stencil_2d,
                                               diffusion_stencil_3d)
from pyamg_tpu_torch.gallery.elasticity import (linear_elasticity,
                                                linear_elasticity_p1)
from pyamg_tpu_torch.gallery.laplacian import poisson
from pyamg_tpu_torch.gallery.stencil import stencil_grid

__all__ = ["advection_2d", "diffusion_stencil_2d", "diffusion_stencil_3d",
           "linear_elasticity", "linear_elasticity_p1", "poisson",
           "stencil_grid"]
