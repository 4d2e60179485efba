"""Polynomial smoother coefficients (reference ``relaxation/chebyshev.py``)."""

from __future__ import annotations

import numpy as np


def chebyshev_polynomial_coefficients(a, b, degree):
    """Coefficients (descending) of the Chebyshev polynomial minimal on
    [a, b] with C(0) = 1 (reference ``chebyshev.py:6``)."""
    if a >= b or a <= 0:
        raise ValueError(f"invalid interval [{a},{b}]")
    std_roots = np.cos(np.pi * (np.arange(degree) + 0.5) / degree)
    scaled_roots = 0.5 * (b - a) * (1 + std_roots) + a
    # monic polynomial with those roots, normalized to C(0)=1
    poly = np.polynomial.polynomial.polyfromroots(scaled_roots)[::-1].real
    return poly / np.polyval(poly, 0)


def mls_polynomial_coefficients(rho, degree):
    """MLS polynomial smoother coefficients (reference ``chebyshev.py:52``,
    Adams/Brezina/Hu/Tuminaro 2003).  Returns (coeffs desc, roots)."""
    roots = rho / 2.0 * (
        1.0 - np.cos(2 * np.pi * (np.arange(degree, dtype=np.float64) + 1)
                     / (2.0 * degree + 1.0)))
    roots = 1.0 / roots
    # ascending monomial coefficients of the S error propagator
    S = np.polynomial.polynomial.polyfromroots(roots).real
    SSA_max = rho / ((2.0 * degree + 1.0) ** 2)
    S_hat = np.polymul(S, S)
    S_hat = np.hstack(((-1.0 / SSA_max) * S_hat, [1]))
    coeffs = np.polymul(S_hat, S)
    coeffs = -coeffs[:-1]
    return coeffs, roots
