"""Build the port's solve-phase hierarchy from plain arrays.

``hierarchy_from_arrays(spec)`` takes numpy arrays and Python scalars and
returns a ``MultilevelSolver`` placed on ``device``, ready for
``solve_refined_device`` (with ``"ds"``) or ``solve`` / ``solve_refined``.
It lets any producer of a compressed hierarchy hand it to the port
without the port's setup phase.  ``spec``::

    {"levels": [                      # finest first; the last is coarsest
        {"A": <operator>, "P": <operator>, "R": <operator>,
         "pre":  <smoother>, "post": <smoother>,
         "splitting": (n,) bool,      # optional: a classical level's
                                      # C points
         "B", "BH": (n, k),           # optional: the level's candidates
         "Cpts", "Fpts": int arrays}, # optional: a root-node level's
        ...,                          # C- and F-points
        {"A": <operator>}],
     "coarse": <coarse solver>,
     "ds": {"kind": "dia", "data_hi", "data_lo", "offsets", "n"}}  # optional

A smoother is ``{"kind", "opts", <params>}``: the descriptor
``(kind, sopts, params)`` of ``relaxation/smoothing.py`` with its static
options under ``"opts"`` and its arrays and scalars beside them:

    gauss_seidel     opts {iterations, sweep, ncolors, omega}; Dinv (n,),
                     colors (n,) int32, order [color, ...]
    jacobi           opts {iterations}; omega, Dinv
    richardson       opts {iterations}; omega
    polynomial       opts {iterations, coefficients} (Chebyshev too)
    jacobi_ne        opts {iterations}; omega
    gauss_seidel_ne  opts {iterations, sweep, ncolors}; colors, omega
    gauss_seidel_nr  as gauss_seidel_ne
    cf_jacobi        opts {iterations, f_iterations, c_iterations};
    fc_jacobi        Cmask, Fmask (n,) bool (else from the level's
                     splitting; on a BELL level split by block row, each
                     block row's for its unknowns), omega, Dinv
    block_gauss_seidel  opts {iterations, sweep, ncolors}; Dinv (nb, br,
                     br) (the pseudo-inverted diagonal blocks), colors
                     (nb,) int32 of the block graph, omega
    block_jacobi     opts {iterations}; omega, Dinv (nb, br, br)
    cf_block_jacobi  opts as cf_jacobi; Cmask, Fmask (nb,) bool (else
    fc_block_jacobi  from the level's splitting, each block row's first
                     unknown), omega, Dinv (nb, br, br)
    krylov_cg, krylov_gmres  opts {maxiter}
    krylov_cgne, krylov_cgnr opts {maxiter}; AH <operator>
    none             {}

The normal-equation kinds get their A^H and row or column norms from the
level's A here (``relaxation.ne_params``) when the producer does not give
``AH`` and ``Dinv``.  A coarse solver is ``{"kind", <factors>}``, the
factors of ``CoarseSolver.from_factors``:

    pinv, pinv2      op (nc, nc)
    lu, splu         lu (nc, nc), piv (nc,): scipy's ``lu_factor``
    cholesky         c (nc, nc), lower: scipy's ``cho_factor``
    jacobi, gauss_seidel, block_jacobi, block_gauss_seidel, none
                     smoother <smoother>
    cg, gmres        maxiter

An operator is one of

    DIA           {"data": (ndiag, npad), "offsets": (...), "shape": (n, n)}
    PhaseStencil  {"arrays": [(n_off_p, *col_grid), ...], "offsets": (...),
                   "row_grid", "col_grid", "ratio", "trans", "nnz"}
    SELL          {"vals": (T, Sy, 128), "delta": (T, Sy, 128) int32,
                   "bases": (T,), "diag": (n,) or (0,), "shape", "t",
                   "kind", "K", "pad_top", "x_rows", "nnz", "base_lo",
                   "base_hi"}
    ELL           {"cols": (n, W), "vals": (n, W), "row_nnz": (n,), "shape"}
    BELL          {"cols": (nb, W), "vals": (nb, W, br, bc),
                   "row_nnz": (nb,), "shape" (scalar), "blocksize"}

``order`` is the color-pass sequence the producer sweeps on a DIA or ELL
level; it must equal the port's own (``relaxation.gs_order``), or the
iterates would differ.  A SELL level sweeps by tiles and needs only
``Dinv``.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import BELL, DIA, ELL, PhaseStencil
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.multilevel import CoarseSolver, Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.relaxation import gs_order, ne_params
from pyamg_tpu_torch.relaxation.smoothing import smoothing_is_symmetric


def _shape(d):
    return tuple(int(s) for s in d["shape"])


def _operator(d):
    if "arrays" in d:
        return PhaseStencil(
            tuple(np.asarray(a) for a in d["arrays"]),
            tuple(tuple(tuple(int(o) for o in off) for off in offs)
                  for offs in d["offsets"]),
            tuple(d["row_grid"]), tuple(d["col_grid"]), tuple(d["ratio"]),
            trans=bool(d["trans"]), _nnz=int(d["nnz"]))
    if "delta" in d:
        return SELL(np.asarray(d["vals"], np.float32),
                    np.asarray(d["delta"], np.int32),
                    tuple(int(b) for b in d["bases"]),
                    np.asarray(d["diag"], np.float32), _shape(d), int(d["t"]),
                    str(d["kind"]), int(d["K"]), int(d["pad_top"]),
                    int(d["x_rows"]), int(d["nnz"]), int(d["base_lo"]),
                    int(d["base_hi"]))
    if "blocksize" in d:
        return BELL(np.asarray(d["cols"], np.int32), np.asarray(d["vals"]),
                    np.asarray(d["row_nnz"], np.int32), _shape(d),
                    tuple(int(b) for b in d["blocksize"]))
    if "cols" in d:
        return ELL(np.asarray(d["cols"], np.int32), np.asarray(d["vals"]),
                   np.asarray(d["row_nnz"], np.int32), _shape(d))
    return DIA(np.asarray(d["data"]), tuple(int(o) for o in d["offsets"]),
               _shape(d))


_CF_KINDS = ("cf_jacobi", "fc_jacobi", "cf_block_jacobi", "fc_block_jacobi")
_NE_DINV = {"jacobi_ne": "Dinv_rows", "gauss_seidel_ne": "Dinv_rows",
            "gauss_seidel_nr": "Dinv_cols"}


def _smoother(d, A, splitting=None):
    kind = d["kind"]
    opts = dict(d.get("opts", {}))
    params = {k: (_operator(v) if k == "AH" else
                  v if np.isscalar(v) or callable(v) else np.asarray(v))
              for k, v in d.items() if k not in ("kind", "opts", "order")}
    if "colors" in params:
        params["colors"] = params["colors"].astype(np.int32)
    if kind in _CF_KINDS and "Cmask" not in params:
        if splitting is None:
            raise ValueError(f"{kind} needs Cmask and Fmask or the level's "
                             f"splitting")
        if isinstance(A, BELL):
            nb = A.n_block_rows
            if kind in ("cf_block_jacobi", "fc_block_jacobi"):
                if splitting.shape[0] != nb:      # per unknown: per block
                    splitting = splitting.reshape(nb, -1)[:, 0]
            elif splitting.shape[0] == nb:        # per block: per unknown
                splitting = np.repeat(splitting, A.blocksize[0])
        params.update(Cmask=splitting, Fmask=~splitting)
    if kind in _NE_DINV and not {"AH", "Dinv"} <= params.keys():
        p = ne_params(A)
        params.update(AH=p["AH"], Dinv=p[_NE_DINV[kind]])
    if kind == "gauss_seidel" and not isinstance(A, SELL):
        order = gs_order(opts["ncolors"], opts["sweep"], opts["iterations"],
                         opts["omega"])
        if list(order) != [int(c) for c in d["order"]]:
            raise ValueError(f"color order {list(d['order'])} differs from "
                             f"the port's {order}")
    return (kind, opts, params)


def _coarse_solver(d, Ac):
    factors = {k: v for k, v in d.items() if k != "kind"}
    if "smoother" in factors:
        factors["smoother"] = _smoother(factors["smoother"], Ac)
    return CoarseSolver.from_factors(d["kind"], factors)


def hierarchy_from_arrays(spec, device="cuda") -> MultilevelSolver:
    """The ``MultilevelSolver`` described by ``spec`` on ``device``."""
    levels = []
    for d in spec["levels"]:
        lvl = Level(_operator(d["A"]))
        split = None
        if "splitting" in d:
            split = np.asarray(d["splitting"]).astype(bool)
            lvl.splitting = split
            lvl.Cpts, lvl.Fpts = np.flatnonzero(split), np.flatnonzero(~split)
        for key in ("B", "BH", "Cpts", "Fpts"):
            if key in d:
                setattr(lvl, key, np.asarray(d[key]))
        if "P" in d:
            lvl.P, lvl.R = _operator(d["P"]), _operator(d["R"])
            lvl.pre = _smoother(d["pre"], lvl.A, split)
            lvl.post = _smoother(d["post"], lvl.A, split)
        levels.append(lvl)
    ml = MultilevelSolver(levels, _coarse_solver(spec["coarse"],
                                                 levels[-1].A))
    ml.symmetric_smoothing = smoothing_is_symmetric(levels)
    if "ds" in spec:
        ml._ds_op = dict(spec["ds"])
        ml._ds_op["offsets"] = tuple(int(o) for o in ml._ds_op["offsets"])
        ml._ds_op["n"] = int(ml._ds_op["n"])
    return ml.to_device(device)
