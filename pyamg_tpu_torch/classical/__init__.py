"""Classical (Ruge-Stuben) AMG and AIR (counterpart of
``pyamg_tpu/classical``)."""

from pyamg_tpu_torch.classical import split
from pyamg_tpu_torch.classical.air import air_solver
from pyamg_tpu_torch.classical.classical import ruge_stuben_solver
from pyamg_tpu_torch.classical.cr import CR, binormalize
from pyamg_tpu_torch.classical.interpolate import (
    classical_interpolation, direct_interpolation, injection_interpolation,
    local_air, one_point_interpolation, remove_strong_FF_connections)

__all__ = ["ruge_stuben_solver", "air_solver", "split", "CR", "binormalize",
           "direct_interpolation", "classical_interpolation",
           "injection_interpolation", "one_point_interpolation",
           "remove_strong_FF_connections", "local_air"]
