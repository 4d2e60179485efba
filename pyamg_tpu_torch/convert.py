"""Build the port's solve-phase hierarchy from plain arrays.

``hierarchy_from_arrays(spec)`` takes numpy arrays and Python scalars and
returns a ``MultilevelSolver`` placed on ``device``, ready for
``solve_refined_device`` (with ``"ds"``) or ``solve`` / ``solve_refined``.
It lets any producer of a compressed hierarchy hand it to the port
without the port's setup phase.  ``spec``::

    {"levels": [                      # finest first; the last is coarsest
        {"A": <operator>, "P": <operator>, "R": <operator>,
         "pre":  {"kind": "gauss_seidel", "opts": {"iterations", "sweep",
                  "ncolors", "omega"}, "Dinv": (n,),
                  "colors": (n,) int32, "order": [color, ...]},
         "post": {... as "pre"}},
        ...,
        {"A": <operator>}],
     "coarse_op": (nc, nc),           # dense inverse of the coarsest A
     "ds": {"kind": "dia", "data_hi", "data_lo", "offsets", "n"}}  # optional

An operator is one of

    DIA           {"data": (ndiag, npad), "offsets": (...), "shape": (n, n)}
    PhaseStencil  {"arrays": [(n_off_p, *col_grid), ...], "offsets": (...),
                   "row_grid", "col_grid", "ratio", "trans", "nnz"}
    SELL          {"vals": (T, Sy, 128), "delta": (T, Sy, 128) int32,
                   "bases": (T,), "diag": (n,) or (0,), "shape", "t",
                   "kind", "K", "pad_top", "x_rows", "nnz", "base_lo",
                   "base_hi"}
    ELL           {"cols": (n, W), "vals": (n, W), "row_nnz": (n,), "shape"}

``order`` is the color-pass sequence the producer sweeps on a DIA or ELL
level; it must equal the port's own (``relaxation.gs_order``), or the
iterates would differ.  A SELL level sweeps by tiles and needs only
``Dinv``.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import DIA, ELL, PhaseStencil
from pyamg_tpu_torch.sparse.sell import SELL
from pyamg_tpu_torch.multilevel import CoarseSolver, Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.relaxation import gs_order


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
    if "cols" in d:
        return ELL(np.asarray(d["cols"], np.int32), np.asarray(d["vals"]),
                   np.asarray(d["row_nnz"], np.int32), _shape(d))
    return DIA(np.asarray(d["data"]), tuple(int(o) for o in d["offsets"]),
               _shape(d))


def _smoother(d, A):
    if d["kind"] != "gauss_seidel":
        raise NotImplementedError(f"smoother {d['kind']!r} is not ported yet")
    opts = dict(d["opts"])
    params = {"Dinv": np.asarray(d["Dinv"])}
    if "colors" in d:
        params["colors"] = np.asarray(d["colors"], np.int32)
    if not isinstance(A, SELL):
        order = gs_order(opts["ncolors"], opts["sweep"], opts["iterations"],
                         opts["omega"])
        if list(order) != [int(c) for c in d["order"]]:
            raise ValueError(f"color order {list(d['order'])} differs from "
                             f"the port's {order}")
    return ("gauss_seidel", opts, params)


def hierarchy_from_arrays(spec, device="cuda") -> MultilevelSolver:
    """The ``MultilevelSolver`` described by ``spec`` on ``device``."""
    levels = []
    for d in spec["levels"]:
        lvl = Level(_operator(d["A"]))
        if "P" in d:
            lvl.P, lvl.R = _operator(d["P"]), _operator(d["R"])
            lvl.pre = _smoother(d["pre"], lvl.A)
            lvl.post = _smoother(d["post"], lvl.A)
        levels.append(lvl)
    cs = CoarseSolver("pinv")
    cs.params = {"op": np.asarray(spec["coarse_op"])}
    ml = MultilevelSolver(levels, coarse_solver=cs)
    if "ds" in spec:
        ml._ds_op = dict(spec["ds"])
        ml._ds_op["offsets"] = tuple(int(o) for o in ml._ds_op["offsets"])
        ml._ds_op["n"] = int(ml._ds_op["n"])
    return ml.to_device(device)
