"""Demo solve (counterpart of ``pyamg_tpu/gallery/demo.py``)."""

from __future__ import annotations

import numpy as np


def demo(device="cuda"):
    """Smoothed aggregation alone and as the preconditioner of CG on 2-D
    Poisson 100^2, on ``device`` (the card by default), with the
    hierarchy and both residual reductions printed (reference
    ``demo.py:9``).  Returns the CG solution as a tensor."""
    from pyamg_tpu_torch.gallery import poisson
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver

    A = poisson((100, 100))
    b = np.random.default_rng(0).random(A.shape[0]).astype(A.dtype)

    ml = smoothed_aggregation_solver(A, max_coarse=10).to_device(device)
    print(ml)

    res1 = []
    x = ml.solve(b, tol=1e-8, residuals=res1)
    print(f"standalone: {len(res1) - 1} cycles, "
          f"rel res {res1[-1] / res1[0]:.2e}")

    res2 = []
    x = ml.solve(b, tol=1e-8, accel="cg", residuals=res2)
    print(f"SA-CG:      {len(res2) - 1} iterations, "
          f"rel res {res2[-1] / res2[0]:.2e}")
    return x
