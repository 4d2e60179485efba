"""Aggregation-based AMG of the port: smoothed, root-node, pairwise and
adaptive smoothed aggregation."""

from pyamg_tpu_torch.aggregation.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.aggregation.aggregate import (
    balanced_lloyd_aggregation, lloyd_aggregation, metis_aggregation,
    naive_aggregation, pairwise_aggregation, standard_aggregation)
from pyamg_tpu_torch.aggregation.tentative import fit_candidates
from pyamg_tpu_torch.aggregation.smooth import (
    jacobi_prolongation_smoother, richardson_prolongation_smoother)
from pyamg_tpu_torch.aggregation.energy import energy_prolongation_smoother
from pyamg_tpu_torch.aggregation.rootnode import rootnode_solver
from pyamg_tpu_torch.aggregation.pairwise import pairwise_solver
from pyamg_tpu_torch.aggregation.adaptive import adaptive_sa_solver

__all__ = [
    "adaptive_sa_solver", "balanced_lloyd_aggregation",
    "energy_prolongation_smoother", "fit_candidates",
    "jacobi_prolongation_smoother", "lloyd_aggregation",
    "metis_aggregation", "naive_aggregation",
    "pairwise_aggregation", "pairwise_solver",
    "richardson_prolongation_smoother", "rootnode_solver",
    "smoothed_aggregation_solver", "standard_aggregation",
]
