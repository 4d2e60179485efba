"""Hierarchy checkpoints: ``save_hierarchy`` and ``load_hierarchy``
(counterpart of ``pyamg_tpu/io.py``).

The file layout is the JAX package's: one ``.npz`` of arrays under flat
keys and a ``__structure__`` JSON record of the levels' containers
(``ELL``, ``BELL``, ``DIA``, ``PhaseStencil``, ``SELL``, which have the same
field names in both packages), smoother descriptors, extras and the
coarse solver.  So ``load_hierarchy`` reads a file that the JAX package
wrote as well as the port's own: the second way, after
``convert.hierarchy_from_arrays``, to carry a JAX hierarchy across.

A loaded hierarchy lands on the host; ``to_device`` moves it.  Where a
smoother's stored parameters lack what the port's form of it reads (the
JAX package keeps no A^H for the normal-equation smoothers, no
diagonal for CF-Jacobi and only the member lists for Schwarz), the
missing ones are rebuilt from the stored ``(kind, sopts)`` on the loaded
A; the stored ones (colors, damping) are kept.  A round trip gives the
identical residual history.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from pyamg_tpu_torch.sparse.matrix import (BELL, DIA, ELL, PhaseStencil,
                                           from_scipy, to_scipy)
from pyamg_tpu_torch.sparse.sell import SELL, sell_to_scipy

_CONTAINERS = {c.__name__: c for c in (ELL, BELL, DIA, PhaseStencil, SELL)}
# fields a placed SELL adds for its kernels; ``to`` makes them again
_DEVICE_FIELDS = {"bases_t", "zero_delta0"}
_LEVEL_EXTRAS = ("B", "AggOp", "T", "C", "Cpts", "Fpts", "splitting",
                 "rho_DinvA")


def _ser(v, key, arrays):
    """The JSON record of one value; its arrays go into ``arrays``."""
    if v is None:
        return {"t": "none"}
    if type(v).__name__ in _CONTAINERS and dataclasses.is_dataclass(v):
        return {"t": "container", "cls": type(v).__name__, "fields": {
            f.name: _ser(getattr(v, f.name), f"{key}.{f.name}", arrays)
            for f in dataclasses.fields(v) if f.name not in _DEVICE_FIELDS}}
    if isinstance(v, torch.Tensor):
        v = v.cpu().numpy()
    if isinstance(v, np.ndarray):
        arrays[key] = v
        return {"t": "arr", "k": key}
    if isinstance(v, (list, tuple)):
        return {"t": "tuple" if isinstance(v, tuple) else "list",
                "items": [_ser(x, f"{key}.{i}", arrays)
                          for i, x in enumerate(v)]}
    if isinstance(v, dict):
        return {"t": "dict", "items": {k: _ser(x, f"{key}.{k}", arrays)
                                       for k, x in v.items()}}
    if isinstance(v, (bool, np.bool_)):
        return {"t": "lit", "v": bool(v)}
    if isinstance(v, (int, float, str)):
        return {"t": "lit", "v": v}
    if isinstance(v, np.integer):
        return {"t": "lit", "v": int(v)}
    if isinstance(v, np.floating):
        return {"t": "lit", "v": float(v)}
    raise TypeError(f"cannot serialize {type(v)!r} at {key}")


def _deser(spec, arrays):
    t = spec["t"]
    if t == "none":
        return None
    if t == "container":
        cls = _CONTAINERS[spec["cls"]]
        kw = {k: _deser(s, arrays) for k, s in spec["fields"].items()}
        for k, v in kw.items():
            if isinstance(v, list):
                kw[k] = tuple(v)
        return cls(**kw)
    if t == "arr":
        return arrays[spec["k"]]
    if t in ("tuple", "list"):
        items = [_deser(s, arrays) for s in spec["items"]]
        return tuple(items) if t == "tuple" else items
    if t == "dict":
        return {k: _deser(s, arrays) for k, s in spec["items"].items()}
    if t == "lit":
        return spec["v"]
    raise TypeError(f"unknown record type {t!r}")


def _coarse_record(cs, arrays):
    """The coarse solver's record, in the JAX package's keys."""
    kind, p, st = cs.kind, cs.params, cs.static
    params, cho_lower, smoother_static = dict(p), None, None
    if "smoother" in st:
        params = {"smoother_params": p["smoother"]}
        smoother_static = [st["smoother"][0], st["smoother"][1]]
    elif "maxiter" in st:
        params = {"maxiter": st["maxiter"]}
    elif "lower" in st:
        cho_lower = st["lower"]
    return {"kind": kind, "opts": cs.opts,
            "params": _ser(params, "coarse.params", arrays),
            "cho_lower": cho_lower, "smoother_static": smoother_static}


def save_hierarchy(ml, path):
    """Write the hierarchy ``ml`` (placed or not) to ``path`` (.npz).  A
    callable coarse solver or smoother, or a sharded hierarchy, cannot be
    written."""
    if getattr(ml, "_mesh", None) is not None:
        raise TypeError("a sharded hierarchy is not serializable: save it "
                        "before shard_hierarchy and shard it again after "
                        "loading")
    cs = ml.coarse_solver
    if callable(cs.kind):
        raise TypeError("callable coarse solvers are not serializable")
    arrays, levels = {}, []
    for i, lvl in enumerate(ml.levels):
        spec = {name: _ser(getattr(lvl, name, None), f"l{i}.{name}", arrays)
                for name in ("A", "P", "R")}
        for name in ("pre", "post"):
            spec[name] = _ser(tuple(getattr(lvl, name)), f"l{i}.{name}",
                              arrays)
        spec["extras"] = {
            name: _ser(getattr(lvl, name), f"l{i}.x.{name}", arrays)
            for name in _LEVEL_EXTRAS if getattr(lvl, name, None) is not None}
        levels.append(spec)
    struct = {"version": 1, "levels": levels,
              "coarse": _coarse_record(cs, arrays),
              "symmetric_smoothing": bool(ml.symmetric_smoothing)}
    np.savez_compressed(path, __structure__=json.dumps(struct), **arrays)


def _host_ell(A):
    """A level's operator as a host ELL, for the setups that rebuild."""
    if isinstance(A, ELL):
        return A
    return from_scipy(sell_to_scipy(A) if isinstance(A, SELL) else
                      to_scipy(A))


def _complete(smoother, A):
    """A stored smoother descriptor with the parameters the port's form
    reads and the file lacks rebuilt on the level's operator A (module
    docstring)."""
    from pyamg_tpu_torch.relaxation import relaxation as rx
    from pyamg_tpu_torch.relaxation.smoothing import _subdomains
    kind, sopts, params = smoother
    sopts, params = dict(sopts), dict(params)
    for k, v in sopts.items():
        if isinstance(v, list):
            sopts[k] = tuple(v)
    if kind in ("jacobi_ne", "gauss_seidel_ne", "gauss_seidel_nr") and \
            "AH" not in params:
        p = rx.ne_params(_host_ell(A))
        params["AH"] = p["AH"]
        params["Dinv"] = p["Dinv_cols" if kind == "gauss_seidel_nr"
                           else "Dinv_rows"]
    elif kind in ("cf_jacobi", "fc_jacobi") and "Dinv" not in params:
        params["Dinv"] = rx.dinv_vec(_host_ell(A))
    elif kind == "schwarz" and "lu" not in params:
        A = _host_ell(A)
        sub = params.get("subdomain")
        params = rx.schwarz_params(A, _subdomains(A) if sub is None
                                   else sub)
    return (kind, sopts, params)


def _coarse_solver(rec, arrays, Ac):
    """The coarse solver of a record written by either package."""
    from pyamg_tpu_torch.multilevel import (CoarseSolver, cholesky_triangle,
                                            row_permutation)
    kind = rec["kind"]
    cs = CoarseSolver(kind, rec["opts"])
    p = _deser(rec["params"], arrays)
    if rec["smoother_static"] is not None:
        ss = rec["smoother_static"]
        _, sopts, params = _complete((ss[0], ss[1], p["smoother_params"]),
                                     Ac)
        cs.static = {"smoother": (ss[0], sopts)}
        cs.params = {"smoother": params}
    elif kind in ("cg", "gmres"):
        cs.static = {"maxiter": int(p["maxiter"])}
    elif kind in ("lu", "splu"):
        cs.params = {"lu": p["lu"], "perm": p["perm"] if "perm" in p
                     else row_permutation(p["piv"])}
    elif kind == "cholesky":
        lower = bool(rec["cho_lower"])
        cs.static = {"lower": lower}
        cs.params = {"c": cholesky_triangle(p["c"], lower)}
    else:
        cs.params = dict(p)
    return cs


def load_hierarchy(path):
    """The hierarchy written to ``path`` by ``save_hierarchy`` of either
    package, on the host."""
    from pyamg_tpu_torch.multilevel import Level, MultilevelSolver
    with np.load(path, allow_pickle=False) as z:
        struct = json.loads(str(z["__structure__"]))
        arrays = {k: z[k] for k in z.files if k != "__structure__"}
    levels = []
    for spec in struct["levels"]:
        lvl = Level(*(_deser(spec[name], arrays) for name in ("A", "P", "R")))
        for name, s in spec.get("extras", {}).items():
            setattr(lvl, name, _deser(s, arrays))
        lvl.pre = _complete(_deser(spec["pre"], arrays), lvl.A)
        lvl.post = _complete(_deser(spec["post"], arrays), lvl.A)
        levels.append(lvl)
    ml = MultilevelSolver(levels, coarse_solver=_coarse_solver(
        struct["coarse"], arrays, levels[-1].A))
    ml.symmetric_smoothing = bool(struct["symmetric_smoothing"])
    return ml
