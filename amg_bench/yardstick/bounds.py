"""The yardstick's constants and counts: the card's published peaks and the
bytes each hand kernel of the port must move for one launch, from the
operator's shape alone.  A launch's bound is its bytes at the peak rate;
each input is counted as read once and each output as written once, what
the kernel reads again is not counted.  Frozen here so that a later
change to the program cannot move them."""

# NVIDIA H100 SXM, data sheet: HBM3 rate, float32 and float64 outside the
# tensor cores, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12


def dia_spmv_bytes(n, ndiag, itemsize):
    """K1 (``dia_spmv``), y = A x on a banded operator of ``n`` rows and
    ``ndiag`` stored diagonals: the band and x read once, y written once."""
    return (ndiag * n + 2 * n) * itemsize


def dia_gs_sweep_bytes(n, ndiag, itemsize):
    """K2 (``dia_gs_sweep``), one multicolor Gauss-Seidel sweep (all its
    color passes in one launch): the band, b, D^-1 and x read once, x
    written once, and one 4-byte color index a row."""
    return (ndiag * n + 4 * n) * itemsize + 4 * n


def bound_seconds(nbytes):
    """The least time the card can take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S
