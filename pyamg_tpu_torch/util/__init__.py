"""Setup-phase utilities of the port (counterpart of ``pyamg_tpu/util``)."""

from pyamg_tpu_torch.util.params import set_tol
from pyamg_tpu_torch.util.linalg import (approximate_spectral_radius, condest,
                                         infinity_norm, ishermitian, norm,
                                         pinv_array)
from pyamg_tpu_torch.util.utils import (
    amalgamate, compute_BtBinv, coord_to_rbm, eliminate_diag_dom_nodes,
    filter_matrix_columns, filter_matrix_rows, filter_operator,
    get_block_diag, get_Cpt_params, get_diagonal, hierarchy_spectrum,
    levelize, profile_solver, scale_columns, scale_rows,
    scale_rows_by_largest_entry, scale_T, symmetric_rescaling,
    symmetric_rescaling_sa, truncate_rows, unamal)
from pyamg_tpu_torch.util.bsr_utils import (bsr_getrow, bsr_row_setscalar,
                                            bsr_row_setvector)

__all__ = [
    "set_tol", "norm", "infinity_norm", "approximate_spectral_radius",
    "condest", "ishermitian", "pinv_array", "levelize", "profile_solver",
    "scale_rows", "scale_columns", "symmetric_rescaling", "get_diagonal",
    "get_block_diag", "amalgamate", "unamal", "coord_to_rbm",
    "eliminate_diag_dom_nodes", "filter_matrix_rows", "compute_BtBinv",
    "filter_operator", "scale_T", "get_Cpt_params", "truncate_rows",
    "hierarchy_spectrum", "bsr_getrow", "bsr_row_setscalar",
    "bsr_row_setvector", "filter_matrix_columns",
    "scale_rows_by_largest_entry", "symmetric_rescaling_sa",
]
