"""pyamg_tpu_torch — algebraic multigrid on PyTorch and CUDA.

The setup phase builds the hierarchy on the host with numpy and scipy;
the solve phase runs on tensors on a CUDA device (the default) or on the
CPU when the caller asks for it.  The banded SpMV and the multicolor
Gauss-Seidel sweep are hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use.

The one-call solve picks a smoothed-aggregation configuration for A,
builds it on the host and solves on the card::

    import pyamg_tpu_torch
    x = pyamg_tpu_torch.solve(A, b, tol=1e-8)

Main path::

    import numpy as np
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import (adaptive_sa_solver, pairwise_solver,
                                         rootnode_solver,
                                         smoothed_aggregation_solver)
    A64 = poisson((500, 500))
    ml = smoothed_aggregation_solver(A64.astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    ml.compress_stencils().collapse_coarse(max_n=4096)
    ml.enable_ds_refinement(A64).to_device()
    x = ml.solve_refined_device(b, tol=1e-10)

Root-node, pairwise and adaptive smoothed aggregation and classical AMG
(Ruge-Stuben and AIR) build their hierarchies the same way::

    from pyamg_tpu_torch.classical import ruge_stuben_solver
    ml = ruge_stuben_solver(A64.astype(np.float32)).compress_stencils()
    x = ml.solve_refined(b, tol=1e-10, accel="cg")
    ml = rootnode_solver(A64, max_coarse=50).compress_stencils()
    ml, work = adaptive_sa_solver(A64, max_coarse=50)
"""

__version__ = "0.1.0"

from pyamg_tpu_torch import gallery, util
from pyamg_tpu_torch._tools import PytestTester
from pyamg_tpu_torch.sparse import BELL, ELL, from_scipy, to_scipy
from pyamg_tpu_torch.aggregation import (adaptive_sa_solver, pairwise_solver,
                                         rootnode_solver,
                                         smoothed_aggregation_solver)
from pyamg_tpu_torch.blackbox import solve, solver, solver_configuration
from pyamg_tpu_torch.classical import air_solver, ruge_stuben_solver
from pyamg_tpu_torch.multilevel import MultilevelSolver, coarse_grid_solver
from pyamg_tpu_torch.convert import hierarchy_from_arrays
from pyamg_tpu_torch.io import load_hierarchy, save_hierarchy

# runs the port's own tests: ``pyamg_tpu_torch.test()``
test = PytestTester(__name__)

__all__ = ["BELL", "ELL", "MultilevelSolver", "adaptive_sa_solver",
           "air_solver", "coarse_grid_solver", "from_scipy", "gallery",
           "hierarchy_from_arrays", "load_hierarchy", "pairwise_solver",
           "rootnode_solver", "ruge_stuben_solver", "save_hierarchy",
           "smoothed_aggregation_solver", "solve", "solver",
           "solver_configuration", "test", "to_scipy", "util"]
