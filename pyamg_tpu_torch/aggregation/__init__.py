"""Smoothed-aggregation AMG of the port."""

from pyamg_tpu_torch.aggregation.aggregation import smoothed_aggregation_solver

__all__ = ["smoothed_aggregation_solver"]
