"""The port's distributed setup (``pyamg_tpu_torch/parallel/dist_setup.py``
and ``scale_model.py``) against the JAX package's, in one process.

The port runs every rank of an 8-rank mesh in this process (a
``StackedMesh`` on the CPU); the JAX package runs on the conftest's 8
virtual devices.  The power iterations of the port start from the JAX
package's own ``jax.random`` vectors, handed in through ``rho_start``, so
that every array of every level can be held to the JAX package's:
integers exactly, float64 values to 1e-12 relative.  The per-rank
primitives that call no collective take plain arrays on both sides; the
aggregation, which exchanges margins, runs under the JAX package's own
``shard_map``.  The tests of ``tests/test_dist_setup.py`` are repeated on
the port where they assert properties of the result.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax import lax

from pyamg_tpu.parallel import dist_setup as jd
from pyamg_tpu.parallel import make_row_mesh as jmesh

from pyamg_tpu_torch.parallel import dist_setup as pd
from pyamg_tpu_torch.parallel import partition as pt
from pyamg_tpu_torch.parallel import scale_model as psm

from test_torch_relaxation import forbid_host_reads

torch.set_num_threads(1)

NDEV = 8
STENCIL = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], np.float64)
FIELDS = ("cols", "vals", "ok", "Dinv", "p_cols", "p_vals", "p_ok",
          "r_cols", "r_vals", "r_ok", "cheb")


def jax_start(seed, rank, n):
    """The JAX package's start vector of ``_power_rho`` on device
    ``rank``."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), rank)
    return np.array(jax.random.normal(key, (n,), jnp.float64))


def mesh8():
    return pd.StackedMesh(NDEV, "cpu")


def grid_pair(N, dtype=np.float64):
    """(JAX arrays and mesh, the port's arrays and mesh) of 2-D Poisson
    N^2 on 8 ranks."""
    jm = jmesh(NDEV)
    j = jd.dist_stencil_grid(STENCIL, (N, N), jm, dtype=dtype)
    m = mesh8()
    p = pd.dist_stencil_grid(STENCIL, (N, N), m, dtype=dtype)
    return (j, jm), (p, m)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-300)
    assert float(np.abs(got - want).max(initial=0.0)) <= rtol * scale


def _tosp(cols, vals, ok, ncols):
    cn, vn, okn = (np.asarray(a) for a in (cols, vals, ok))
    rows = np.repeat(np.arange(cn.shape[0]), cn.shape[1])
    m = okn.ravel()
    return sp.csr_matrix((vn.ravel()[m], (rows[m], cn.ravel()[m])),
                         shape=(cn.shape[0], ncols))


# -- the gallery -----------------------------------------------------------

@pytest.mark.parametrize("N,dtype", [(40, np.float64), (33, np.float32)])
def test_dist_stencil_grid_matches_jax(N, dtype):
    """Each rank's rows (33^2 pads 1089 rows to 1096 with identity rows)."""
    ((jc, jv, jo, jn), _), ((c, v, o, n), _) = grid_pair(N, dtype)
    assert n == jn
    _same(c, jc)
    _same(v, jv)
    _same(o, jo)
    assert c.dtype == torch.int32 and v.dtype == torch.from_numpy(
        np.empty(0, dtype)).dtype


def _aniso():
    from pyamg_tpu.gallery import diffusion_stencil_2d, stencil_grid
    st = np.asarray(diffusion_stencil_2d(epsilon=1e-2, theta=np.pi / 6,
                                         type="FE"))
    return stencil_grid(st, (48, 48), format="csr")


@pytest.mark.parametrize("rcm", [False, True])
def test_dist_from_scipy_matches_jax(rcm):
    A = _aniso()
    jc, jv, jo, jn, jperm = jd.dist_from_scipy(A, jmesh(NDEV),
                                               dtype=jnp.float64, rcm=rcm)
    c, v, o, n, perm = pd.dist_from_scipy(A, mesh8(), dtype=torch.float64,
                                          rcm=rcm)
    assert n == jn
    _same(perm, jperm)
    _same(c, jc)
    _same(v, jv)
    _same(o, jo)


# -- the per-rank primitives -----------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_dedup_rows_matches_jax(dtype):
    """Random rows with duplicates and invalid slots: columns and counts
    exactly, values to 1e-12 (float64) or a few ulps (float32) of the
    largest."""
    from pyamg_tpu.ops.rowops import dedup_rows as jdedup
    from pyamg_tpu_torch.ops.rowops import dedup_rows
    rng = np.random.default_rng(0)
    cols = rng.integers(0, 10, (64, 16)).astype(np.int32)
    vals = rng.standard_normal((64, 16)).astype(dtype)
    valid = rng.random((64, 16)) < 0.8
    want = jdedup(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid),
                  10)
    got = dedup_rows(torch.as_tensor(cols), torch.as_tensor(vals),
                     torch.as_tensor(valid), 10)
    _same(got[0], want[0])
    _same(got[2], want[2])
    _close(got[1], want[1], 1e-12 if dtype == np.float64 else 4e-7)
    # a leading axis of ranks is a batch
    got3 = dedup_rows(*(torch.as_tensor(a).view(4, 16, 16)
                        for a in (cols, vals, valid)), 10)
    for a, b in zip(got3, got):
        _same(a.reshape(b.shape), b)


def _one(*arrays):
    """Plain arrays as the port's (R = 1, ...) blocks."""
    return [torch.as_tensor(np.asarray(a))[None] for a in arrays]


def test_truncate_by_mag_matches_jax():
    rng = np.random.default_rng(1)
    cols = rng.integers(0, 50, (30, 12)).astype(np.int32)
    vals = rng.standard_normal((30, 12))
    ok = rng.random((30, 12)) < 0.7
    for width in (5, 12, 15):
        want = jd._truncate_by_mag(jnp.asarray(cols), jnp.asarray(vals),
                                   jnp.asarray(ok), width)
        got = pd._truncate_by_mag(*_one(cols, vals, ok), width)
        for g, w in zip(got[:3], want[:3]):
            _same(g[0], w)
        assert int(got[3][0]) == int(want[3])


def test_spgemm_shard_matches_jax():
    """A rows against a ghost-extended B whose rows start at ``base``,
    with rows wider than the cap: columns, masks and drops exactly, values
    to 1e-12."""
    rng = np.random.default_rng(2)
    n, WA, ne, WB, base, ncol = 30, 11, 40, 4, 7, 25
    a_cols = rng.integers(0, ne + 2 * base, (n, WA)).astype(np.int32)
    a_vals = rng.standard_normal((n, WA))
    a_ok = rng.random((n, WA)) < 0.8
    b_cols = rng.integers(0, ncol, (ne, WB)).astype(np.int32)
    b_vals = rng.standard_normal((ne, WB))
    b_ok = rng.random((ne, WB)) < 0.8
    want = jd._spgemm_shard(*(jnp.asarray(a) for a in (
        a_cols, a_vals, a_ok, b_cols, b_vals, b_ok)), base, ncol, 10)
    got = pd._spgemm_shard(*_one(a_cols, a_vals, a_ok, b_cols, b_vals,
                                 b_ok), torch.tensor([base]), ncol, 10)
    _same(got[0][0], want[0])
    _same(got[2][0], want[2])
    _close(got[1][0], want[1])
    assert int(got[3][0]) == int(want[3]) > 0


def test_transpose_shard_matches_jax():
    rng = np.random.default_rng(3)
    ne, WP, col0, c_cap = 50, 4, 10, 12
    p_cols = rng.integers(0, 30, (ne, WP)).astype(np.int32)
    p_vals = rng.standard_normal((ne, WP))
    p_ok = rng.random((ne, WP)) < 0.8
    for width in (3, 16):
        want = jd._transpose_shard(jnp.asarray(p_cols), jnp.asarray(p_vals),
                                   jnp.asarray(p_ok), col0, c_cap, width)
        got = pd._transpose_shard(*_one(p_cols, p_vals, p_ok),
                                  torch.tensor([col0]), c_cap, width)
        for g, w in zip(got[:3], want[:3]):
            _same(g[0], w)
        assert int(got[3][0]) == int(want[3])


def test_mis_hash_matches_numpy_uint32():
    rows = np.concatenate([np.arange(1000), 2 ** 31 - 1 - np.arange(1000),
                           np.random.default_rng(4).integers(0, 2 ** 31,
                                                             1000)])
    prod = rows.astype(np.uint32) * np.uint32(2654435761)
    for shift in (1, 17):
        want = (prod >> np.uint32(shift)).astype(np.int64)
        _same(pd.mis_hash(torch.as_tensor(rows), shift), want)


def test_hashed_start_matches_the_reference_script():
    import jax_dist_setup_reference as jref
    for seed, rank, n in ((0, 0, 17), (3, 5, 1000), (99, 7, 249925)):
        rows = rank * n + jnp.arange(n, dtype=jnp.int64)
        want = np.asarray(jref.hashed_start(jnp.int64(seed), rows))
        _same(pd.hashed_start(seed, rank, n), want)


def test_mis_and_propagation_match_jax_across_ranks():
    """Level 0 of 40^2 (theta = 0: every off-diagonal entry strong): the
    MIS-2 roots and the propagated labels on the 8-rank mesh equal the JAX
    package's under its ``shard_map``."""
    from jax.sharding import PartitionSpec as P
    ((jc, jv, jo, n_loc), jm), ((c, v, o, _), m) = grid_pair(40)
    g = jd._margin_of(jc, jo, n_loc, jm)

    def body(cols_b, vals_b, ok_b):
        row0 = lax.axis_index("rows") * n_loc
        rows_g = row0 + jnp.arange(n_loc, dtype=jnp.int32)
        strong = ok_b & (cols_b != rows_g[:, None])
        eligible = jnp.any(strong, axis=1)
        roots = jd._mis2_global(cols_b, strong, eligible, rows_g, row0, g,
                                NDEV)
        lab = jnp.where(roots, rows_g, -1)
        w = jnp.where(strong, jnp.abs(vals_b), 0)
        return roots, jd._propagate_global(cols_b, strong, w, lab, eligible,
                                           row0, g, NDEV, rounds=3)

    f = jd.shard_map(body, mesh=jm, in_specs=(P("rows", None),) * 3,
                     out_specs=(P("rows"), P("rows")))
    jroots, jlab = jax.jit(f)(jc, jv, jo)

    ex = pd.exchange_of(m)
    assert pd._margin_of(ex, c, o, n_loc) == g
    cb, vb, ob = pd._blocks(ex, n_loc, c.long(), v, o)
    row0 = ex.row0(n_loc)
    rows_g = row0[:, None] + torch.arange(n_loc)
    strong = ob & (cb != rows_g[..., None])
    eligible = strong.any(-1)
    roots = pd._mis2_global(ex, cb, strong, eligible, rows_g, row0, g)
    lab = pd._propagate_global(ex, cb, strong,
                               torch.where(strong, vb.abs(), 0),
                               torch.where(roots, rows_g, -1), eligible,
                               row0, g, rounds=3)
    _same(roots.reshape(-1), jroots)
    _same(lab.reshape(-1), jlab)
    assert int(roots.sum()) > 0 and bool((lab >= 0).all())


# -- whole setups against the JAX package ------------------------------------

SETUPS = {"sa": {}, "chebyshev": {"smoother": "chebyshev"},
          "classical": {}}


@pytest.fixture(scope="module")
def pairs():
    """(JAX hierarchy, port hierarchy, b) of each setup at 40^2 on 8
    ranks, float64, the port started from the JAX vectors."""
    ((jc, jv, jo, jn), jm), ((c, v, o, n), m) = grid_pair(40)
    out = {}
    for name, kw in SETUPS.items():
        jf = jd.distributed_classical_setup if name == "classical" else \
            jd.distributed_sa_setup
        pf = pd.distributed_classical_setup if name == "classical" else \
            pd.distributed_sa_setup
        J = jf(jc, jv, jo, jn, jm, coarsen_until=64, **kw)
        H = pf(c, v, o, n, m, coarsen_until=64, rho_start=jax_start, **kw)
        out[name] = (J, H)
    b = np.random.default_rng(0).standard_normal(c.shape[0])
    b[1600:] = 0.0
    return out, b


@pytest.mark.parametrize("name", list(SETUPS))
def test_setup_matches_jax_array_for_array(pairs, name):
    J, H = pairs[0][name]
    assert len(H.levels) == len(J.levels) >= 2
    for k in ("margins", "nagg", "dropped"):
        assert H.diagnostics[k] == J.diagnostics[k], k
    assert len(H.diagnostics["seconds"]) == len(H.levels)
    for i, (L, K) in enumerate(zip(H.levels, J.levels)):
        assert (L.n_loc, L.g, L.gp, L.gcp, L.n) == \
            (K.n_loc, K.g, K.gp, K.gcp, K.n), i
        assert L.omega == pytest.approx(K.omega, rel=1e-12)
        for f in FIELDS:
            a, w = getattr(L, f), getattr(K, f)
            assert (a is None) == (w is None), (i, f)
            if a is None:
                continue
            if a.is_floating_point():
                _close(a, w)
            else:
                _same(a, w)
        assert L.nnz() == K.nnz()
    assert H.coarse_n == J.coarse_n
    _close(H.coarse_dense, J.coarse_dense)
    assert H.operator_complexity() == J.operator_complexity()


@pytest.mark.parametrize("name,solve", [("sa", "cg"), ("chebyshev", "cg"),
                                        ("classical", "fgmres")])
def test_solves_match_jax(pairs, name, solve):
    """``solve_cg`` to 1e-8 and ``solve_fgmres`` (restart 10): the same
    iterations, relres to 1e-10 and x to 1e-10 of the JAX package's."""
    (J, H), b = pairs[0][name], pairs[1]
    kw = dict(tol=1e-8, maxiter=40) if solve == "cg" else \
        dict(tol=1e-8, restart=10, max_outer=4)
    jx, jrel, jit = getattr(J, f"solve_{solve}")(jnp.asarray(b), **kw)
    x, rel, it = getattr(H, f"solve_{solve}")(b, **kw)
    assert it == jit > 0
    assert rel == pytest.approx(jrel, rel=1e-10)
    _close(x, jx, 1e-10)


@pytest.mark.parametrize("name,solve", [("sa", "cg"), ("chebyshev", "cg"),
                                        ("classical", "fgmres")])
def test_solves_as_programs_match_jax(pairs, name, solve):
    """``solve_cg`` and ``solve_fgmres`` as captured programs (the stand-in
    of ``torch_stand_in.py``: each step recorded with its host reads
    refused, the loop run as a device runs it), twice: bit for bit the
    eager solve, and so the JAX package's iterations, relres to 1e-10 and
    x to 1e-10."""
    from pyamg_tpu_torch import _graph
    from torch_stand_in import stand_in_programs
    (J, H), b = pairs[0][name], pairs[1]
    kw = dict(tol=1e-8, maxiter=40) if solve == "cg" else \
        dict(tol=1e-8, restart=10, max_outer=4)
    jx, jrel, jit = getattr(J, f"solve_{solve}")(jnp.asarray(b), **kw)
    with _graph.eager():
        want = getattr(H, f"solve_{solve}")(b, **kw)
    try:
        with stand_in_programs():
            for _ in range(2):
                x, rel, it = getattr(H, f"solve_{solve}")(b, **kw)
                assert torch.equal(x, want[0]) and (rel, it) == want[1:]
        assert H._graph_cache.captured()[0] == 2
    finally:
        H.__dict__.pop("_graph_cache", None)
    assert it == jit > 0
    assert rel == pytest.approx(jrel, rel=1e-10)
    _close(x, jx, 1e-10)


def test_vcycle_reads_nothing_on_the_host(pairs, monkeypatch):
    """One V-cycle of the sharded hierarchy (margin exchanges, the dense
    coarse solve) with every host read of a tensor patched to raise, and
    no ``aten::item`` in its profile."""
    _, H = pairs[0]["sa"]
    ex = pd.exchange_of(H.mesh)
    _, Mmv = H._operators(ex, 2)
    b = H._local(ex, pairs[1])
    forbid_host_reads(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x = Mmv(b)
    monkeypatch.undo()
    assert not [e.name for e in prof.events()
                if e.name in ("aten::item", "aten::_local_scalar_dense")]
    assert bool(torch.isfinite(x).all()) and x.shape == b.shape


@pytest.fixture(scope="module")
def one_rank_group():
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield pt.make_row_mesh(1, device="cpu")
    if made:
        dist.destroy_process_group()


def test_one_rank_group_equals_one_stacked_rank(one_rank_group):
    """A one-rank ``RowMesh`` and a one-rank ``StackedMesh`` build the
    same hierarchy and CG, bit for bit (the chip's check of the NCCL
    path, here on gloo)."""
    out = []
    for mesh in (one_rank_group, pd.StackedMesh(1, "cpu")):
        c, v, o, n = pd.dist_stencil_grid(STENCIL, (24, 24), mesh,
                                          dtype=torch.float64)
        H = pd.distributed_sa_setup(c, v, o, n, mesh, coarsen_until=40)
        b = np.random.default_rng(5).standard_normal(c.shape[0])
        out.append((H, H.solve_cg(b, tol=1e-8, maxiter=30)))
    (H1, (x1, r1, i1)), (H2, (x2, r2, i2)) = out
    assert len(H1.levels) == len(H2.levels) >= 2
    for L1, L2 in zip(H1.levels, H2.levels):
        assert L1.omega == L2.omega
        for f in FIELDS:
            a, w = getattr(L1, f), getattr(L2, f)
            if a is not None:
                _same(a, w)
    _same(x1, x2)
    assert (r1, i1) == (r2, i2) and r1 < 1e-8


# -- the JAX package's own assertions, on the port ----------------------------

def _port_sa(N, dtype=torch.float64, **kw):
    m = mesh8()
    c, v, o, n = pd.dist_stencil_grid(STENCIL, (N, N), m, dtype=dtype)
    return pd.distributed_sa_setup(c, v, o, n, m, **kw), c.shape[0]


def _r_global(L0, c_cap, n_loc, g, n):
    """R of level 0 with global fine columns (its columns index each
    rank's gp-extended fine rows)."""
    rc, rv, rok = (np.asarray(a) for a in (L0.r_cols, L0.r_vals, L0.r_ok))
    rows_g, cols_g, vals_g = [], [], []
    for d in range(NDEV):
        blk = slice(d * c_cap, (d + 1) * c_cap)
        glob = rc[blk] + d * n_loc - g
        mm = rok[blk] & (glob >= 0) & (glob < n)
        ridx = np.repeat(np.arange(d * c_cap, (d + 1) * c_cap),
                         rc.shape[1]).reshape(c_cap, -1)
        rows_g.append(ridx[mm])
        cols_g.append(glob[mm])
        vals_g.append(rv[blk][mm])
    return sp.csr_matrix((np.concatenate(vals_g), (np.concatenate(rows_g),
                                                   np.concatenate(cols_g))),
                         shape=(NDEV * c_cap, n))


def test_galerkin_matches_scipy_rap_exactly(pairs):
    """Ac equals R A P of the gathered operators, R equals Pᵀ, unused
    coarse slots are identity rows and Ac is symmetric
    (``test_dist_setup.py::test_galerkin_matches_scipy_rap_exactly``)."""
    _, H = pairs[0]["sa"]
    assert sum(H.diagnostics["dropped"]) == 0
    L0, L1 = H.levels[0], H.levels[1]
    n, nc = L0.n, L1.n
    A = _tosp(L0.cols, L0.vals, L0.ok, n)
    P = _tosp(L0.p_cols, L0.p_vals, L0.p_ok, nc)
    Ac = _tosp(L1.cols, L1.vals, L1.ok, nc)
    R = _r_global(L0, L1.n_loc, L0.n_loc, L0.gp, n)
    assert abs(R - P.T).max() == 0
    used = np.asarray(R.sum(axis=1)).ravel() != 0
    D = (Ac - R @ A @ P).tocsr()
    assert abs(D[used]).max() < 1e-13
    assert abs(D[~used] - sp.eye(nc).tocsr()[~used]).max() < 1e-13
    assert abs(Ac - Ac.T).max() < 1e-13


def test_classical_r_equals_pt(pairs):
    _, H = pairs[0]["classical"]
    L0, L1 = H.levels[0], H.levels[1]
    P = _tosp(L0.p_cols, L0.p_vals, L0.p_ok, L1.n)
    R = _r_global(L0, L1.n_loc, L0.n_loc, L0.gp, L0.n)
    assert abs(R - P.T).max() == 0
    used = np.asarray(abs(P).sum(axis=0)).ravel() != 0
    ones = (P.toarray() == 1.0).sum(axis=0)
    assert (ones[used] >= 1).all()


def test_three_sharded_levels_and_chebyshev():
    """96^2: three sharded levels (coarse margins wider than a rank's
    block), CG to 1e-8 with Jacobi and with Chebyshev, Chebyshev in no
    more iterations and at most 12 (``TestDistChebyshev``)."""
    b = np.random.default_rng(0).standard_normal(96 * 96 + 0)
    its = {}
    for sm in ("jacobi", "chebyshev"):
        H, npad = _port_sa(96, coarsen_until=300, smoother=sm)
        assert len(H.levels) >= 3
        assert any(L.g > L.n_loc for L in H.levels[1:])
        bb = np.zeros(npad)
        bb[:96 * 96] = b
        x, relres, it = H.solve_cg(bb, tol=1e-8, maxiter=60)
        assert relres < 1e-8, (sm, relres)
        its[sm] = it
    assert its["chebyshev"] <= its["jacobi"] and its["chebyshev"] <= 12


def test_dist_from_scipy_anisotropic():
    """Rotated anisotropic diffusion through the general row ingestion
    (``test_dist_from_scipy_anisotropic``)."""
    A = _aniso()
    n = A.shape[0]
    m = mesh8()
    c, v, o, n_loc, perm = pd.dist_from_scipy(A, m, dtype=torch.float64,
                                              rcm=False)
    H = pd.distributed_sa_setup(c, v, o, n_loc, m, coarsen_until=100)
    b = np.zeros(c.shape[0])
    b[:n] = np.random.default_rng(6).standard_normal(n)
    x, relres, it = H.solve_cg(b, tol=1e-8, maxiter=80)
    assert relres < 1e-8, (relres, it)
    true = np.linalg.norm(b[:n] - A @ x.numpy()[:n]) / np.linalg.norm(b[:n])
    assert true < 1e-7


def test_advection_classical_fgmres():
    """Advection-diffusion 64^2 from a host CSR, classical hierarchy,
    FGMRES to 1e-8 within 60 iterations (``TestDistFGMRES``)."""
    from pyamg_tpu_torch.gallery import advection_2d
    from pyamg_tpu_torch.sparse.matrix import to_scipy
    A, rhs = advection_2d((64, 64))
    As = to_scipy(A).tocsr()
    n = As.shape[0]
    m = mesh8()
    c, v, o, n_loc, perm = pd.dist_from_scipy(As, m, dtype=torch.float64,
                                              rcm=False)
    b = np.zeros(c.shape[0])
    b[:n] = np.asarray(rhs)
    H = pd.distributed_classical_setup(c, v, o, n_loc, m, coarsen_until=120)
    x, relres, it = H.solve_fgmres(b, tol=1e-8, restart=20, max_outer=8)
    assert relres < 1e-8 and it <= 60, (relres, it)
    true = np.linalg.norm(b[:n] - As @ x.numpy()[:n]) / np.linalg.norm(b[:n])
    assert true < 1e-7


@pytest.mark.parametrize("N,mc", [(40, 64), (96, 300)])
def test_dist_vs_host_convergence_quality(N, mc):
    """The sharded hierarchy's CG takes at most 1.4 times the iterations
    of the port's own single-host SA with the same smoothing
    (``test_dist_vs_host_convergence_quality``)."""
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    H, npad = _port_sa(N, coarsen_until=mc)
    n = N * N
    b = np.random.default_rng(7).standard_normal(npad)
    b[n:] = 0.0
    x, relres, it_dist = H.solve_cg(b, tol=1e-8, maxiter=60)
    assert relres < 1e-8
    jac = ("jacobi", {"omega": 4.0 / 3.0, "iterations": 2})
    ml = smoothed_aggregation_solver(poisson((N, N)), max_coarse=mc,
                                     presmoother=jac, postsmoother=jac)
    res = []
    ml.to_device("cpu").solve(b[:n], tol=1e-8, maxiter=60, accel="cg",
                              residuals=res)
    assert it_dist <= 1.4 * (len(res) - 1), (N, it_dist, len(res) - 1)


# -- the memory model --------------------------------------------------------

def test_scale_model_matches_built_shapes():
    """The port's model replays the shape laws and the steady-state bytes
    of a built float32 hierarchy (``TestScaleModel``)."""
    H, _ = _port_sa(192, dtype=torch.float32, coarsen_until=300)
    for i, L in enumerate(H.levels[:-1]):
        Lc = H.levels[i + 1]
        wp, wr, wac = psm._caps(L.cols.shape[1])
        mdl = psm.LevelModel(n_loc=L.n_loc, W=L.cols.shape[1], wp=wp, wr=wr,
                             c_cap=Lc.n_loc, g=L.g,
                             gP=pd._transfer_margin(L.g, L.n_loc, NDEV))
        assert tuple(L.p_cols.shape) == (NDEV * L.n_loc, wp), i
        assert tuple(L.r_cols.shape) == (NDEV * Lc.n_loc, wr), i
        assert Lc.cols.shape[1] == wac, i
        assert L.gp == mdl.gP, i
        nbytes = sum(a.numel() * a.element_size() for a in (
            L.cols, L.vals, L.ok, L.Dinv, L.p_cols, L.p_vals, L.p_ok,
            L.r_cols, L.r_vals, L.r_ok))
        assert nbytes // NDEV == mdl.operator_bytes(), i


@pytest.mark.parametrize("n,W,ndev", [(1414 ** 2, 5, 8), (10 ** 8, 7, 64),
                                      (500 ** 2, 9, 4)])
def test_scale_model_matches_jax(n, W, ndev):
    from pyamg_tpu.parallel.scale_model import summarize as jsummarize
    assert psm.summarize(n, W, ndev, hbm_bytes=16e9) == \
        jsummarize(n, W, ndev, hbm_bytes=16e9)
    assert psm.summarize(n, W, ndev)["hbm_gb"] == 80.0
