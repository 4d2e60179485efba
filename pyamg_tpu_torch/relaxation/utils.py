"""Relaxation as a linear operator (counterpart of
``pyamg_tpu/relaxation/utils.py``).

``relaxation_as_linear_operator((name, {opts}), A, b)`` sets the smoother
up once on A and returns an object whose ``matvec(v)`` (also ``@`` and
``*``) runs one application of it on A x = b from ``v``: the form the SA
constructors use to improve near-nullspace candidates (b = 0).  A is a
host operator and ``v`` a numpy vector: this is the setup phase.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.relaxation.smoothing import (apply_smoother,
                                                  make_smoother)


class _RelaxationOperator:
    def __init__(self, method, A, b=None):
        fn, kwargs = method if isinstance(method, tuple) else (method, {})
        self.A = A
        self.shape = (A.shape[0], A.shape[0])
        self.dtype = A.dtype
        self._kind, self._sopts, self._params = \
            make_smoother(None, A, (fn, kwargs))
        self._b = b

    def matvec(self, v):
        v = np.asarray(v)
        b = np.zeros_like(v) if self._b is None else \
            np.broadcast_to(np.asarray(self._b), v.shape)
        return apply_smoother(self._kind, self._sopts, self._params,
                              self.A, v, b)

    def __matmul__(self, v):
        return self.matvec(v)

    __mul__ = __matmul__


def relaxation_as_linear_operator(method, A, b=None):
    """An operator whose matvec runs one relaxation application on
    ``A x = b`` (default b = 0) from the operand as initial guess."""
    return _RelaxationOperator(method, A, b)
