"""Smoothers of the port: Jacobi, Gauss-Seidel/SOR, polynomial,
normal-equation, block, Schwarz and Krylov smoothers."""

from pyamg_tpu_torch.relaxation import relaxation
from pyamg_tpu_torch.relaxation.chebyshev import (
    chebyshev_polynomial_coefficients, mls_polynomial_coefficients)
from pyamg_tpu_torch.relaxation.utils import relaxation_as_linear_operator

__all__ = ["relaxation", "chebyshev_polynomial_coefficients",
           "mls_polynomial_coefficients", "relaxation_as_linear_operator"]
