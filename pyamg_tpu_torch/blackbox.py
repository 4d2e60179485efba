"""One-call solve with generic, robust settings (counterpart of
``pyamg_tpu/blackbox.py``; reference ``pyamg/blackbox.py``).

``solver_configuration`` picks smoothed-aggregation options from a fast
Hermitian test of A, ``solver`` builds the hierarchy on the host, and
``solve`` runs it on the card (or on ``device``) as the preconditioner of
CG for a Hermitian A with symmetric smoothing, else of GMRES.
"""

from __future__ import annotations

import warnings

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, asarray_or_ell


def make_operator(A):
    """A user's matrix (scipy sparse, dense, ELL or BELL) as a host ELL, or
    a BELL for a BSR matrix (reference ``make_csr:12``)."""
    return asarray_or_ell(A)


def solver_configuration(A, B=None, verb=True):
    """Smoothed-aggregation options for an arbitrary A (reference
    ``blackbox.py:52``): by ``ishermitian(A, fast_check=True)``, energy
    smoothing by CG and symmetric (block) Gauss-Seidel for a Hermitian A,
    else energy smoothing by GMRES and symmetric Gauss-Seidel on the
    normal equations; evolution strength, standard aggregation,
    ``max_coarse=500`` and a ``pinv`` coarse solve.  ``B`` defaults to
    ones, or on a BELL to one candidate per unknown of a block."""
    from pyamg_tpu_torch.util.linalg import ishermitian
    A = make_operator(A)
    config = {}
    if ishermitian(A, fast_check=True):
        config["symmetry"] = "hermitian"
        if verb:
            print("  Detected a Hermitian matrix")
    else:
        config["symmetry"] = "nonsymmetric"
        if verb:
            print("  Detected a non-Hermitian matrix")

    if config["symmetry"] == "hermitian":
        config["smooth"] = ("energy", {"krylov": "cg", "maxiter": 3,
                                       "degree": 2, "weighting": "local"})
        config["presmoother"] = ("block_gauss_seidel",
                                 {"sweep": "symmetric", "iterations": 1})
        config["postsmoother"] = ("block_gauss_seidel",
                                  {"sweep": "symmetric", "iterations": 1})
    else:
        config["smooth"] = ("energy", {"krylov": "gmres", "maxiter": 3,
                                       "degree": 2, "weighting": "local"})
        config["presmoother"] = ("gauss_seidel_nr",
                                 {"sweep": "symmetric", "iterations": 2})
        config["postsmoother"] = ("gauss_seidel_nr",
                                  {"sweep": "symmetric", "iterations": 2})

    if B is None:
        if isinstance(A, BELL) and A.blocksize[0] > 1:
            bs = A.blocksize[0]
            config["B"] = np.kron(np.ones((A.shape[0] // bs, 1)),
                                  np.eye(bs))
        else:
            config["B"] = np.ones((A.shape[0], 1))
    else:
        B = np.asarray(B)
        if B.ndim == 1:
            B = B.reshape(-1, 1)
        if B.shape[0] != A.shape[0] or B.shape[1] == 0:
            raise TypeError("Invalid dimensions of B, B.shape[0] must "
                            "equal A.shape[0]")
        config["B"] = B
    config["BH"] = None if config["symmetry"] == "hermitian" \
        else config["B"].copy()

    config["strength"] = ("evolution", {"k": 2, "proj_type": "l2",
                                        "epsilon": 3.0})
    config["max_levels"] = 15
    config["max_coarse"] = 500
    config["coarse_solver"] = "pinv"
    config["aggregate"] = "standard"
    config["keep"] = False
    return config


def solver(A, config):
    """The smoothed-aggregation hierarchy of ``config`` on the host
    (reference ``blackbox.py:154``); a failed setup raises ``TypeError``
    from its cause."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    A = make_operator(A)
    try:
        return smoothed_aggregation_solver(
            A, B=config["B"], BH=config["BH"], smooth=config["smooth"],
            strength=config["strength"], max_levels=config["max_levels"],
            max_coarse=config["max_coarse"],
            coarse_solver=config["coarse_solver"],
            symmetry=config["symmetry"], aggregate=config["aggregate"],
            presmoother=config["presmoother"],
            postsmoother=config["postsmoother"], keep=config["keep"])
    except Exception as e:
        raise TypeError("Failed generating smoothed_aggregation_solver") \
            from e


def solve(A, b, x0=None, tol=1e-5, maxiter=400, return_solver=False,
          existing_solver=None, verb=True, residuals=None, device="cuda"):
    """Solve A x = b with the out-of-the-box choice (reference
    ``blackbox.py:208``): the hierarchy of ``solver_configuration``, or
    ``existing_solver``, placed on ``device`` (the card by default) and
    used by CG where it and A are symmetric, else by GMRES, from ``x0``
    (by default ``default_rng(17).random(n)`` in A's dtype) to ``tol``
    within ``maxiter`` iterations.  Warnings are silenced during the
    solve.  Returns x as a tensor on ``device`` (and the hierarchy, with
    ``return_solver``); ``residuals`` is filled with the residual norms.

    Examples
    --------
    >>> import numpy as np
    >>> import pyamg_tpu_torch
    >>> from pyamg_tpu_torch.gallery import poisson
    >>> from pyamg_tpu_torch.sparse.matrix import to_scipy
    >>> A = poisson((20, 20))
    >>> b = np.ones(400)
    >>> x = pyamg_tpu_torch.solve(A, b, verb=False, tol=1e-8, device="cpu")
    >>> bool(np.linalg.norm(b - to_scipy(A) @ x.numpy())
    ...      < 1e-5 * np.linalg.norm(b))
    True
    """
    from pyamg_tpu_torch._device import resolve
    A = make_operator(A)
    b = np.asarray(b).reshape(-1)
    if x0 is None:
        x0 = np.random.default_rng(17).random(A.shape[0]).astype(A.dtype)

    if existing_solver is None:
        ml = solver(A, solver_configuration(A, verb=verb))
    else:
        ml = existing_solver
        if ml.levels[0].A.shape[0] != A.shape[0]:
            raise TypeError("Argument existing_solver must have level 0 "
                            "matrix of same size as A")
    device = resolve(device)
    if ml.device != device:
        ml.to_device(device)

    symmetry = getattr(ml.levels[0], "symmetry", "hermitian")
    accel = "cg" if ml.symmetric_smoothing and symmetry == "hermitian" \
        else "gmres"
    if verb:
        print(f"  Using {accel} acceleration")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        x = ml.solve(b, x0=x0, accel=accel, tol=tol, maxiter=maxiter,
                     residuals=residuals)
    if return_solver:
        return x, ml
    return x
