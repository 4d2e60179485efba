"""Visualization helpers of the port, host only (counterpart of
``pyamg_tpu/vis``)."""

from pyamg_tpu_torch.vis.vtk_writer import write_basic_mesh, write_vtu
from pyamg_tpu_torch.vis.vis_coarse import vis_aggregate_groups, vis_splitting

__all__ = ["write_vtu", "write_basic_mesh", "vis_aggregate_groups",
           "vis_splitting"]
