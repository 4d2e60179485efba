"""Build the port's solve-phase hierarchy from plain arrays.

``hierarchy_from_arrays(spec)`` takes numpy arrays and Python scalars and
returns a ``MultilevelSolver`` placed on ``device``, ready for
``solve_refined_device``.  It lets any producer of a compressed, collapsed
hierarchy hand it to the port without the port's setup phase.  ``spec``::

    {"levels": [                      # finest first; the last is coarsest
        {"A": {"data": (ndiag, npad), "offsets": (...), "shape": (n, n)},
         "P": {"arrays": [(n_off_p, *col_grid), ...], "offsets": (...),
               "row_grid": (...), "col_grid": (...), "ratio": (...),
               "trans": False, "nnz": int},
         "R": {... as P, with "trans": True},
         "pre":  {"kind": "gauss_seidel", "opts": {"iterations", "sweep",
                  "ncolors", "omega"}, "colors": (n,) int32, "Dinv": (n,),
                  "order": [color, ...]},
         "post": {... as "pre"}},
        ...,
        {"A": {...}}],
     "coarse_op": (nc, nc),           # dense inverse of the coarsest A
     "ds": {"kind": "dia", "data_hi", "data_lo", "offsets", "n"}}

``order`` is the color-pass sequence the producer sweeps; it must equal
the port's own (``relaxation.gs_order``), or the iterates would differ.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import DIA, PhaseStencil
from pyamg_tpu_torch.multilevel import CoarseSolver, Level, MultilevelSolver
from pyamg_tpu_torch.relaxation.relaxation import gs_order


def _dia(d):
    return DIA(np.asarray(d["data"]), tuple(int(o) for o in d["offsets"]),
               tuple(int(s) for s in d["shape"]))


def _phase(d):
    return PhaseStencil(
        tuple(np.asarray(a) for a in d["arrays"]),
        tuple(tuple(tuple(int(o) for o in off) for off in offs)
              for offs in d["offsets"]),
        tuple(d["row_grid"]), tuple(d["col_grid"]), tuple(d["ratio"]),
        trans=bool(d["trans"]), _nnz=int(d["nnz"]))


def _smoother(d):
    if d["kind"] != "gauss_seidel":
        raise NotImplementedError(f"smoother {d['kind']!r} is not ported yet")
    opts = dict(d["opts"])
    order = gs_order(opts["ncolors"], opts["sweep"], opts["iterations"],
                     opts["omega"])
    if list(order) != [int(c) for c in d["order"]]:
        raise ValueError(f"color order {list(d['order'])} differs from the "
                         f"port's {order}")
    return ("gauss_seidel", opts,
            {"colors": np.asarray(d["colors"], np.int32),
             "Dinv": np.asarray(d["Dinv"])})


def hierarchy_from_arrays(spec, device="cuda") -> MultilevelSolver:
    """The ``MultilevelSolver`` described by ``spec`` on ``device``."""
    levels = []
    for d in spec["levels"]:
        lvl = Level(_dia(d["A"]))
        if "P" in d:
            lvl.P, lvl.R = _phase(d["P"]), _phase(d["R"])
            lvl.pre, lvl.post = _smoother(d["pre"]), _smoother(d["post"])
        levels.append(lvl)
    cs = CoarseSolver("pinv")
    cs.params = {"op": np.asarray(spec["coarse_op"])}
    ml = MultilevelSolver(levels, coarse_solver=cs)
    ml._ds_op = dict(spec["ds"])
    ml._ds_op["offsets"] = tuple(int(o) for o in ml._ds_op["offsets"])
    ml._ds_op["n"] = int(ml._ds_op["n"])
    return ml.to_device(device)
