"""Smoothers of the port: multicolor Gauss-Seidel."""
