"""Smoother setup and application (counterpart of the scalar Gauss-Seidel
part of ``pyamg_tpu/relaxation/smoothing.py``).

A smoother is a triple ``(kind, sopts, params)``: ``kind`` and the static
options ``sopts`` choose the code path, ``params`` holds the arrays
(colors, Dinv) that ``MultilevelSolver.to_device`` moves to the card.
"""

from __future__ import annotations

from pyamg_tpu_torch.sparse.matrix import ELL
from pyamg_tpu_torch.relaxation import relaxation as rx


def rho_D_inv_A(A, seed=0):
    """Spectral radius of D^-1 A (host ELL)."""
    from pyamg_tpu_torch.util.linalg import approximate_spectral_radius
    from pyamg_tpu_torch.ops.spmv import spmv
    Dinv = rx.dinv_vec(A)

    class _Op:
        shape = A.shape
        dtype = A.dtype

        @staticmethod
        def matvec(v):
            return Dinv * spmv(A, v)

    return approximate_spectral_radius(_Op, seed=seed)


def setup_none(level, A, opts):
    return ("none", {}, {})


def setup_gauss_seidel(level, A, opts):
    if not isinstance(A, ELL):
        raise NotImplementedError(
            "Gauss-Seidel setup takes a scalar ELL operator; block (BELL) "
            "smoothers are not ported yet")
    colors, nc = rx.make_coloring(A)
    # omega is static (an option, not a param) so that the sweep can drop
    # repeated colors when omega == 1
    return ("gauss_seidel",
            {"iterations": int(opts.get("iterations", 1)),
             "sweep": opts.get("sweep", "forward"), "ncolors": nc,
             "omega": 1.0},
            {"colors": colors, "Dinv": rx.dinv_vec(A)})


def setup_block_gauss_seidel(level, A, opts):
    return setup_gauss_seidel(level, A, opts)


_SETUPS = {
    None: setup_none, "none": setup_none,
    "gauss_seidel": setup_gauss_seidel,
    "block_gauss_seidel": setup_block_gauss_seidel,
}


def unpack_arg(v):
    """PyAMG's ``(name, {opts})`` convention."""
    if isinstance(v, tuple):
        return v[0], dict(v[1])
    return v, {}


def make_smoother(level, A, spec):
    name, opts = unpack_arg(spec)
    if name not in _SETUPS:
        raise NotImplementedError(f"smoother {name!r} is not ported yet")
    return _SETUPS[name](level, A, opts)


def change_smoothers(ml, presmoother, postsmoother):
    """Attach smoother descriptors to every level but the coarsest."""
    npre = len(ml.levels) - 1
    if npre == 0:
        return
    pres = presmoother if isinstance(presmoother, list) else \
        [presmoother] * npre
    posts = postsmoother if isinstance(postsmoother, list) else \
        [postsmoother] * npre
    pres = (pres + [pres[-1]] * npre)[:npre]
    posts = (posts + [posts[-1]] * npre)[:npre]
    for lvl, pre, post in zip(ml.levels[:-1], pres, posts):
        lvl.pre = make_smoother(lvl, lvl.A, pre)
        lvl.post = make_smoother(lvl, lvl.A, post)


def apply_smoother(kind, sopts, params, A, x, b):
    if kind == "none":
        return x
    if kind == "gauss_seidel":
        return rx.gauss_seidel(A, x, b, iterations=sopts["iterations"],
                               sweep=sopts["sweep"], colors=params["colors"],
                               ncolors=sopts["ncolors"], Dinv=params["Dinv"],
                               omega=sopts["omega"])
    raise NotImplementedError(f"smoother kind {kind!r} is not ported yet")
