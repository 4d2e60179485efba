"""The port's additive Schwarz (``relaxation.schwarz``, the
``schwarz``/``strength_based_schwarz`` smoothers and the ``schwarz``
coarse solve) against the JAX package's, on the CPU, in float64.

One subdomain covering every node solves exactly (against
``np.linalg.solve``, 1e-12).  The smoothers of 2-D Poisson 16^2 and a
rotated anisotropic diffusion set up on SA hierarchies, with and without
``keep``, sweep as the JAX package's (1e-12 of the largest entry), and
their solves take its residual history (1e-10 relative).  A sweep reads
nothing on the host.  On a compressed level the port raises a
``TypeError`` that names the cause, where the JAX package stops with an
``AttributeError``.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from pyamg_tpu.aggregation import smoothed_aggregation_solver as ref_sa
from pyamg_tpu.gallery import diffusion_stencil_2d as ref_stencil_2d
from pyamg_tpu.gallery import poisson as ref_poisson
from pyamg_tpu.gallery import stencil_grid as ref_stencil_grid
from pyamg_tpu.multilevel import coarse_grid_solver as ref_coarse
from pyamg_tpu.relaxation import relaxation as ref_rx
from pyamg_tpu.relaxation.smoothing import apply_smoother as ref_apply

from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import diffusion_stencil_2d, poisson, stencil_grid
from pyamg_tpu_torch.multilevel import MultilevelSolver, coarse_grid_solver
from pyamg_tpu_torch.relaxation import relaxation as rx
from pyamg_tpu_torch.relaxation.smoothing import apply_smoother
from pyamg_tpu_torch.sparse.matrix import to_scipy

from test_torch_rootnode import on_cpu

torch.set_num_threads(1)


def _operators(name):
    if name == "poisson":
        return poisson((16, 16)), ref_poisson((16, 16))
    st = dict(epsilon=1e-2, theta=np.pi / 6, type="FE")
    return (stencil_grid(diffusion_stencil_2d(**st), (16, 16)),
            ref_stencil_grid(ref_stencil_2d(**st), (16, 16)))


def _vectors(n):
    rng = np.random.default_rng(5)
    return rng.standard_normal(n), rng.standard_normal(n)


def test_one_subdomain_covering_all_solves_exactly():
    A, _ = _operators("anisotropic")
    n = A.shape[0]
    _, b = _vectors(n)
    x = rx.schwarz(A, np.zeros(n), b, np.arange(n)[None, :])
    want = np.linalg.solve(to_scipy(A).toarray(), b)
    assert np.abs(x - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("matrix", ["poisson", "anisotropic"])
def test_sweep_matches_reference(matrix):
    """Two sweeps over the default subdomains (each row's pattern), and
    over padded subdomains of two members, on host and CPU tensors."""
    A, Ar = _operators(matrix)
    n = A.shape[0]
    x0, b = _vectors(n)
    pairs = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    pairs[::3, 1] = -1
    from pyamg_tpu_torch.relaxation.smoothing import _subdomains
    for sub in (_subdomains(A), pairs):
        want = np.asarray(ref_rx.schwarz(Ar, jnp.asarray(x0), jnp.asarray(b),
                                         jnp.asarray(sub), iterations=2))
        scale = np.abs(want).max()
        got = rx.schwarz(A, x0, b, sub, iterations=2)
        assert np.abs(got - want).max() <= 1e-12 * scale
        got = rx.schwarz(A.to("cpu"), torch.as_tensor(x0), torch.as_tensor(b),
                         sub, iterations=2)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * scale


SMOOTHERS = [("schwarz", False), ("strength_based_schwarz", False),
             ("strength_based_schwarz", True)]


@pytest.fixture(scope="module")
def hierarchies():
    out = {}
    for matrix in ("poisson", "anisotropic"):
        A, Ar = _operators(matrix)
        for name, keep in SMOOTHERS:
            kw = dict(presmoother=(name, {"iterations": 2}),
                      postsmoother=name, keep=keep, max_coarse=20)
            out[matrix, name, keep] = (smoothed_aggregation_solver(A, **kw),
                                       ref_sa(Ar, **kw))
    return out


@pytest.mark.parametrize("matrix", ["poisson", "anisotropic"])
@pytest.mark.parametrize("smoother", SMOOTHERS,
                         ids=lambda s: f"{s[0]}-keep={s[1]}")
def test_smoothers_match_reference(hierarchies, matrix, smoother):
    """Every level's pre- and postsmoother sweeps as the JAX package's:
    the strength-based subdomains are the rows of the kept C, or of A
    without ``keep``."""
    ml, mr = hierarchies[(matrix,) + smoother]
    assert len(ml.levels) == len(mr.levels) >= 2
    for lp, lr in zip(ml.levels[:-1], mr.levels[:-1]):
        n = lp.A.shape[0]
        x0, b = _vectors(n)
        for attr in ("pre", "post"):
            kind, sopts, params = getattr(lp, attr)
            rkind, rsopts, rparams = getattr(lr, attr)
            assert (kind, sopts) == (rkind, rsopts)
            np.testing.assert_array_equal(params["subdomain"],
                                          np.asarray(rparams["subdomain"]))
            want = np.asarray(ref_apply(rkind, rsopts, rparams, lr.A,
                                        jnp.asarray(x0), jnp.asarray(b)))
            got = apply_smoother(kind, sopts, params, lp.A.to("cpu"),
                                 torch.as_tensor(x0), torch.as_tensor(b))
            assert np.abs(got.numpy() - want).max() <= \
                1e-12 * np.abs(want).max()


@pytest.mark.parametrize("matrix", ["poisson", "anisotropic"])
@pytest.mark.parametrize("smoother", SMOOTHERS,
                         ids=lambda s: f"{s[0]}-keep={s[1]}")
def test_solve_matches_reference(hierarchies, matrix, smoother):
    ml, mr = hierarchies[(matrix,) + smoother]
    b = np.random.default_rng(0).random(ml.levels[0].A.shape[0])
    got, want = [], []
    on_cpu(ml).solve(b, tol=1e-8, maxiter=60, residuals=got)
    mr.solve(jnp.asarray(b), tol=1e-8, maxiter=60, residuals=want)
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want)
    assert np.abs(got - want).max() <= 1e-10 * want[0]


def test_schwarz_is_not_a_symmetric_smoother(hierarchies):
    """As in the JAX package, CG with Schwarz smoothing warns."""
    ml, _ = hierarchies["poisson", "schwarz", False]
    assert not ml.symmetric_smoothing
    with pytest.warns(UserWarning, match="non-symmetric"):
        on_cpu(ml).solve(np.ones(ml.levels[0].A.shape[0]), accel="cg",
                         maxiter=2)


def test_coarse_solve_matches_reference():
    A, Ar = _operators("anisotropic")
    _, b = _vectors(A.shape[0])
    cs, cr = coarse_grid_solver(("schwarz", {"iterations": 3})), \
        ref_coarse(("schwarz", {"iterations": 3}))
    cs.setup(A)
    cr.setup(Ar)
    cs.params = {"smoother": {k: torch.as_tensor(v) for k, v in
                              cs.params["smoother"].items()}}
    want = np.asarray(cr(Ar, jnp.asarray(b)))
    got = cs(A.to("cpu"), torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_a_sweep_reads_nothing_on_the_host(hierarchies):
    """One sweep on CPU tensors: no ``aten::item`` and no
    ``aten::_local_scalar_dense`` (the triangular solves check nothing),
    so a cycle with Schwarz reads nothing on the host."""
    from torch.profiler import ProfilerActivity, profile
    ml = on_cpu(hierarchies["poisson", "schwarz", False][0])
    lvl = ml.levels[0]
    x0, b = (torch.as_tensor(v) for v in _vectors(lvl.A.shape[0]))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        apply_smoother(*lvl.pre, lvl.A, x0, b)
    names = {e.name for e in prof.events()}
    assert "aten::linalg_solve_triangular" in names
    assert not names & {"aten::item", "aten::_local_scalar_dense"}


def test_a_compressed_level_raises(hierarchies):
    """After ``compress_stencils`` the fine level is a DIA: the port raises
    its ``TypeError``, the JAX package an ``AttributeError``."""
    ml, mr = hierarchies["poisson", "strength_based_schwarz", True]
    b = np.ones(ml.levels[0].A.shape[0])
    twin = MultilevelSolver(
        [copy.copy(lvl) for lvl in ml.levels],
        coarse_solver=copy.copy(ml.coarse_solver)).compress_stencils()
    with pytest.raises(TypeError, match=r"uncompressed \(ELL\) hierarchy"):
        twin.to_device("cpu").solve(b, maxiter=1)
    mr_c = ref_sa(_operators("poisson")[1], presmoother="schwarz",
                  postsmoother="schwarz", max_coarse=20).compress_stencils()
    with pytest.raises(AttributeError):
        mr_c.solve(jnp.asarray(b), maxiter=1)
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell
    with pytest.raises(TypeError, match="DIA"):
        rx.schwarz(dia_from_ell(ml.levels[0].A), b, b,
                   np.arange(b.shape[0])[None, :])


@pytest.mark.parametrize("accel", ["bicgstab", "cr"])
def test_generic_krylov_methods_with_schwarz(accel):
    """BiCGStab and CR with Schwarz smoothing on 2-D Poisson 24^2, where
    the JAX package raises (its ``schwarz`` converts a tracer to numpy):
    each reaches tol, x is within 1e-6 relative of scipy's direct solve,
    and the device-stopped solve (CUDA graphs by the CPU stand-in) equals
    its op-by-op form bit for bit."""
    from scipy.sparse.linalg import spsolve
    from pyamg_tpu_torch import _graph
    from torch_stand_in import stand_in_programs
    A = poisson((24, 24))
    ml = on_cpu(smoothed_aggregation_solver(
        A, presmoother="schwarz", postsmoother="schwarz", max_coarse=20))
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    runs = []
    for form in (_graph.eager, stand_in_programs, stand_in_programs):
        res = []
        with form():
            x, info = ml.solve(b, tol=1e-10, maxiter=100, accel=accel,
                               residuals=res, return_info=True)
        runs.append((x, info, res))
    x, info, res = runs[0]
    assert info == 0 and res[-1] <= 1e-10 * res[0]
    want = spsolve(to_scipy(A).tocsc(), b)
    assert np.linalg.norm(np.asarray(x) - want) <= \
        1e-6 * np.linalg.norm(want)
    for got in runs[1:]:
        assert torch.equal(torch.as_tensor(got[0]), torch.as_tensor(x))
        assert got[1:] == (info, res)
