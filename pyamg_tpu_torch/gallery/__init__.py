"""Model problems of the port (counterpart of ``pyamg_tpu/gallery``)."""

from pyamg_tpu_torch.gallery.stencil import stencil_grid
from pyamg_tpu_torch.gallery.laplacian import gauge_laplacian, poisson
from pyamg_tpu_torch.gallery.diffusion import (diffusion_stencil_2d,
                                               diffusion_stencil_3d)
from pyamg_tpu_torch.gallery.advection import advection_2d
from pyamg_tpu_torch.gallery.elasticity import (linear_elasticity,
                                                linear_elasticity_p1)
from pyamg_tpu_torch.gallery.mesh import regular_triangle_mesh
from pyamg_tpu_torch.gallery.random_sparse import sprand
from pyamg_tpu_torch.gallery.example import load_example
from pyamg_tpu_torch.gallery.demo import demo

__all__ = [
    "stencil_grid", "poisson", "gauge_laplacian",
    "diffusion_stencil_2d", "diffusion_stencil_3d", "advection_2d",
    "linear_elasticity", "linear_elasticity_p1", "regular_triangle_mesh",
    "sprand", "load_example", "demo",
]
