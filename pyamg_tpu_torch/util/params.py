"""Tolerance by dtype (counterpart of ``pyamg_tpu/util/params.py``)."""

import numpy as np


def set_tol(dtype):
    """A small tolerance matched to ``dtype``'s precision (real or
    complex): 1e2 eps of half, 1e3 eps of single, 1e6 eps of double and
    of long double (reference ``util/params.py:6``)."""
    ch = np.dtype(dtype).char.lower()
    if ch == "e":
        return 1e2 * float(np.finfo(np.float16).eps)
    if ch == "f":
        return 1e3 * float(np.finfo(np.single).eps)
    if ch == "d":
        return 1e6 * float(np.finfo(np.double).eps)
    if ch == "g":
        return 1e6 * float(np.finfo(np.longdouble).eps)
    raise ValueError(
        "Attempting to set a tolerance for an unsupported precision.")
