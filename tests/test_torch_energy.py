"""The port's energy-minimising prolongation smoothing
(``aggregation/energy.py``) and its helpers in ``util/utils.py`` against
the JAX package's, on the CPU.

Each case builds its inputs once in the JAX package (symmetric strength,
standard aggregation, the tentative prolongator, and for root-node cases
``scale_T`` and ``get_Cpt_params``) and hands the same arrays to both
packages: cg, cgnr and gmres, with and without the C-point identity rows,
each prefilter (``theta``, ``k``, both) and postfilter (the same, with
its second pass), each weighting, on a scalar operator (2-D Poisson 12^2)
and on a block one (2-D linear elasticity 6^2 with its three rigid-body
modes, through unamalgamation).

Tolerances: float64 throughout.  The JAX package runs the minimisation as
a jitted scan whose masked product sums through a sort and running sums;
the port runs scipy's product: the pattern of P must be equal and its
values within 1e-10 of the largest.  The constraint ``P @ Bc = T @ Bc``
(root-node: ``P @ Bc = Bf``, the fine candidates) holds in the port to
1e-10 of the largest wherever no filter drops entries of T (and not on
the block root-node case, whose two-column blocks cannot hold the third,
rotational candidate; neither package's P does), and a root-node P is
the identity at the C-points.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyamg_tpu.aggregation.aggregate import standard_aggregation as ref_std
from pyamg_tpu.aggregation.energy import \
    energy_prolongation_smoother as ref_energy
from pyamg_tpu.aggregation.tentative import fit_candidates as ref_fit
from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.sparse.matrix import BELL as RefBELL
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy
from pyamg_tpu.strength import strength_measure as ref_strength
from pyamg_tpu.util import utils as ref_utils

from pyamg_tpu_torch.aggregation.energy import energy_prolongation_smoother
from pyamg_tpu_torch.sparse.matrix import BELL, ELL, to_scipy
from pyamg_tpu_torch.util import utils

torch.set_num_threads(1)

TOL = 1e-10


def port(op):
    """The port's container of a JAX package host ELL or BELL."""
    if isinstance(op, RefBELL):
        return BELL(np.asarray(op.cols), np.asarray(op.vals),
                    np.asarray(op.row_nnz), tuple(op.shape),
                    tuple(op.blocksize))
    return ELL(np.asarray(op.cols), np.asarray(op.vals),
               np.asarray(op.row_nnz), tuple(op.shape))


def same_operator(got, want, tol=TOL, strict=True):
    """Equal pattern, values within ``tol`` of the largest.  Not
    ``strict``: an entry stored on one side only must be within ``tol`` of
    the largest (a rounding residue the other side computed as 0)."""
    g, w = to_scipy(got).tocsr(), ref_to_scipy(want).tocsr()
    g.sort_indices()
    w.sort_indices()
    assert g.shape == w.shape
    scale = np.abs(w.data).max() if w.nnz else 0.0
    if not strict:
        assert abs(g - w).max() <= tol * scale
        one_sided = (abs(g) > 0) != (abs(w) > 0)
        assert one_sided.nnz <= max(1, w.nnz // 1000)
        return
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    if w.nnz:
        assert np.abs(g.data - w.data).max() <= tol * scale


def _inputs(kind):
    """(A, T, C, Bc, Bf, Cpt_params) in the JAX package, for plain SA
    (``'sa'``) or root-node SA (``'rootnode'``) on the ``scalar`` or
    ``block`` operator."""
    system, form = kind
    if system == "scalar":
        A = ref_poisson((12, 12))
        B = np.ones((A.shape[0], 1))
        bs = 1
    else:
        A, B = ref_elasticity((6, 6))
        B = np.asarray(B)
        bs = 2
    C = ref_strength(A, ("symmetric", {}))
    AggOp, Cnodes = ref_std(C)
    if form == "sa":
        T, Bc = ref_fit(AggOp, B)
        return A, T, C, np.asarray(Bc), B, (False, {})
    T, _ = ref_fit(AggOp, B[:, :bs])
    T = ref_utils.scale_T(T, Cnodes)
    params = ref_utils.get_Cpt_params(A, Cnodes)
    return A, T, C, B[params["Cpts"]], B, (True, params)


_CACHE = {}


def inputs(kind):
    if kind not in _CACHE:
        _CACHE[kind] = _inputs(kind)
    return _CACHE[kind]


def _port_args(A, T, C, Bc, Bf, cpt=None):
    return port(A), port(T), port(C), Bc, Bf


CASES = (
    [("scalar", form, krylov, {}) for krylov in ("cg", "cgnr", "gmres")
     for form in ("sa", "rootnode")] +
    [("scalar", form, "cg", {"prefilter": pre}) for form in ("sa", "rootnode")
     for pre in ({"theta": 0.5}, {"k": 3}, {"theta": 0.5, "k": 2})] +
    [("scalar", "rootnode", "cg", {"postfilter": post})
     for post in ({"theta": 0.3}, {"k": 3}, {"theta": 0.3, "k": 2})] +
    [("scalar", "sa", "cg", {"weighting": w}) for w in ("diagonal", "block")] +
    [("scalar", "sa", "cg", {"degree": 2, "maxiter": 6})] +
    [("block", form, krylov, {}) for form in ("sa", "rootnode")
     for krylov in ("cg", "gmres")])


def _id(case):
    system, form, krylov, kw = case
    extra = "-".join(f"{k}={v}" for k, v in kw.items())
    return "-".join(filter(None, (system, form, krylov, extra)))


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_energy_smoother_matches_reference(case):
    system, form, krylov, kw = case
    args = inputs((system, form))
    want = ref_energy(*args[:5], Cpt_params=args[5], krylov=krylov, **kw)
    got = energy_prolongation_smoother(*_port_args(*args),
                                       Cpt_params=args[5], krylov=krylov,
                                       **kw)
    assert type(got).__name__ == type(want).__name__
    same_operator(got, want)
    _, T, _, Bc, Bf, cpt = args
    P = to_scipy(got)
    if cpt[0]:
        # the C-points' rows are the identity
        Cpts = cpt[1]["Cpts"]
        np.testing.assert_array_equal(
            P.tocsr()[Cpts].toarray(),
            np.eye(P.shape[1])[cpt[1]["coarse_id"][Cpts]])
    if not kw.get("prefilter") and not kw.get("postfilter") and \
            not (cpt[0] and system == "block"):
        # root-node SA holds P @ Bc to the fine candidates
        want_PB = Bf if cpt[0] else ref_to_scipy(T) @ Bc
        assert np.abs(P @ Bc - want_PB).max() <= \
            TOL * np.abs(want_PB).max()


def test_energy_smoother_keeps_its_dtype():
    """float32 in, float32 out, the minimisation in float32 throughout
    (the JAX package's scan promotes its iterate to float64 here and
    raises; ``test_torch_rootnode`` holds the whole float32 hierarchy)."""
    A, T, C, Bc, Bf, cpt = inputs(("scalar", "rootnode"))
    A32, T32, C32 = (port(M).astype(np.float32) for M in (A, T, C))
    P = energy_prolongation_smoother(A32, T32, C32, Bc.astype(np.float32),
                                     Bf.astype(np.float32), Cpt_params=cpt)
    assert P.vals.dtype == np.float32
    P64 = energy_prolongation_smoother(*_port_args(A, T, C, Bc, Bf, cpt),
                                       Cpt_params=cpt)
    same_operator(P, P64, tol=1e-5)


def test_energy_smoother_checks_its_options():
    args = _port_args(*inputs(("scalar", "sa")))
    for kw in ({"krylov": "bicg"}, {"weighting": "row"},
               {"prefilter": {"q": 1}}, {"tol": 2.0}, {"maxiter": -1}):
        with pytest.raises(ValueError):
            energy_prolongation_smoother(*args, **kw)


# -- util/utils.py ------------------------------------------------------------

def test_truncate_rows_matches_reference():
    A = ref_poisson((9, 9))
    vals = np.asarray(A.vals) * np.random.default_rng(3).random(A.vals.shape)
    A = type(A)(A.cols, jnp.asarray(vals), A.row_nnz, A.shape)
    for k in (1, 2, 4):
        same_operator(utils.truncate_rows(port(A), k),
                      ref_utils.truncate_rows(A, k), tol=0)


@pytest.mark.parametrize("system", ["scalar", "block"])
def test_root_node_scaffolding_matches_reference(system):
    """scale_T, get_Cpt_params and filter_operator (with compute_BtBinv)."""
    A, T, C, Bc, Bf, (_, params) = inputs((system, "rootnode"))
    got = utils.get_Cpt_params(port(A), np.asarray(
        ref_std(ref_strength(A, ("symmetric", {})))[1]))
    for key in ("Cpts", "Fpts", "coarse_id"):
        np.testing.assert_array_equal(got[key], params[key])
    _, Cnodes = ref_std(ref_strength(A, ("symmetric", {})))
    bs = 1 if system == "scalar" else 2
    AggOp, _ = ref_std(ref_strength(A, ("symmetric", {})))
    T0, _ = ref_fit(AggOp, np.asarray(Bf)[:, :bs])
    same_operator(utils.scale_T(port(T0), np.asarray(Cnodes)),
                  ref_utils.scale_T(T0, Cnodes), tol=0)
    if system == "scalar":
        pattern = ref_strength(A, ("symmetric", {}))
        from pyamg_tpu.ops.spgemm import spgemm as ref_spgemm
        wide = ref_spgemm(pattern, T)
        got = utils.filter_operator(port(T), port(wide), Bc, Bf)
        want = ref_utils.filter_operator(T, wide, Bc, Bf)
        same_operator(got, want)
        np.testing.assert_allclose(
            utils.compute_BtBinv(Bc, port(wide)),
            np.asarray(ref_utils.compute_BtBinv(Bc, wide)), rtol=1e-12)
