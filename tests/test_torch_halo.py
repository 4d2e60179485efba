"""The port's halo-exchange SpMV (``pyamg_tpu_torch/parallel/halo.py``)
against the JAX package's (``pyamg_tpu/parallel/halo.py``), and the
sharded solve in a one-rank gloo group made in this process.

``build_halo_plan`` builds every rank's plan on the host; the tests hold
it array for array against the JAX package's ``build_halo`` fields, and
run every rank's step (``halo_send`` feeding the receivers'
``halo_local_mv``) in one loop against its ``HaloELL.mv`` on the
conftest's virtual devices.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from pyamg_tpu.gallery import poisson as jpoisson, sprand as jsprand
from pyamg_tpu.sparse.matrix import to_scipy as jto_scipy

from pyamg_tpu_torch.parallel import halo as ph
from pyamg_tpu_torch.parallel import partition as pt
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy

from test_torch_relaxation import forbid_host_reads

torch.set_num_threads(1)


def _transfer():
    rng = np.random.default_rng(0)
    n, m = 97, 25
    rows = np.arange(n)
    cols = np.minimum(rows // 4, m - 1)
    return sp.csr_array((rng.standard_normal(n), (rows, cols)),
                        shape=(n, m)).tocsr()


def _cases():
    S = jto_scipy(jsprand(150, 150, 6.0 / 150, seed=3))
    return {"poisson23x17": jto_scipy(jpoisson((23, 17))).tocsr(),
            "sprand150": (S + S.T).tocsr(),
            "transfer97x25": _transfer(),
            "poisson40": jto_scipy(jpoisson((40,))).tocsr(),
            "poisson16x16": jto_scipy(jpoisson((16, 16))).tocsr()}


CASES = _cases()


def _ref_halo(S, ndev):
    from pyamg_tpu.parallel import make_row_mesh
    from pyamg_tpu.parallel.halo import build_halo
    from pyamg_tpu.sparse.matrix import from_scipy as jfrom_scipy
    return build_halo(jfrom_scipy(S), make_row_mesh(ndev))


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_matches_build_halo(case, ndev):
    H = _ref_halo(CASES[case], ndev)
    plan = ph.build_halo_plan(from_scipy(CASES[case]), ndev)
    np.testing.assert_array_equal(plan.cols, np.asarray(H.cols))
    np.testing.assert_array_equal(plan.vals, np.asarray(H.vals))
    assert len(plan.send_idx) == len(H.send_idx)
    for got, want in zip(plan.send_idx, H.send_idx):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert plan.offsets == H.offsets and plan.seg_sizes == H.seg_sizes
    assert plan.shape == H.shape
    assert (plan.n_loc, plan.m_loc, plan.ndev) == (H.n_loc, H.m_loc, ndev)


def emulate(plan, x):
    """Every rank's step of ``plan`` in one loop: rank e's send buffer for
    offset o goes to rank (e + o) % ndev, which concatenates what it
    receives in offset order; the ranks' rows laid end to end."""
    p = plan.ndev
    xt = torch.as_tensor(x).reshape((p, plan.m_loc) + x.shape[1:])
    sends = [ph.halo_send(xt[e], [torch.as_tensor(s[e]).long()
                                  for s in plan.send_idx])
             for e in range(p)]
    ys = []
    for d in range(p):
        segs = [sends[(d - o) % p][k] for k, o in enumerate(plan.offsets)]
        ys.append(ph.halo_local_mv(torch.as_tensor(plan.cols[d]).long(),
                                   torch.as_tensor(plan.vals[d]), xt[d],
                                   segs))
    return torch.cat(ys).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_ranks_match_halo_mv(case):
    """8 ranks' steps against the JAX package's ``HaloELL.mv`` (shard_map
    and ppermute over 8 devices) and scipy, to 1e-12."""
    S = CASES[case]
    H = _ref_halo(S, 8)
    plan = ph.build_halo_plan(from_scipy(S), 8)
    x = np.zeros(plan.shape[1])
    x[:S.shape[1]] = np.random.default_rng(7).standard_normal(S.shape[1])
    y = emulate(plan, x)
    want = np.asarray(jax.jit(H.mv)(jnp.asarray(x)))
    np.testing.assert_allclose(y, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y[:S.shape[0]], S @ x[:S.shape[1]],
                               rtol=1e-12, atol=1e-12)


def test_emulated_ranks_take_a_2d_x():
    """An (n, k) x is one exchange of (S_o, k) buffers; each column equals
    the 1-D product."""
    S = CASES["poisson23x17"]
    plan = ph.build_halo_plan(from_scipy(S), 8)
    X = np.zeros((plan.shape[1], 3))
    X[:S.shape[1]] = np.random.default_rng(3).standard_normal((S.shape[1],
                                                               3))
    Y = emulate(plan, X)
    for j in range(3):
        np.testing.assert_array_equal(Y[:, j], emulate(plan, X[:, j].copy()))


def test_poisson_traffic_is_ring_neighbours():
    plan = ph.build_halo_plan(from_scipy(CASES["poisson23x17"]), 8)
    assert set(plan.offsets) <= {1, 7}


@pytest.mark.parametrize("case", ["poisson40", "poisson23x17"])
def test_extract_diagonal_halo_matches(case):
    """Every rank's block of the diagonal, pad rows reading 1, against the
    JAX package's ``extract_diagonal_halo``."""
    from pyamg_tpu.parallel.halo import extract_diagonal_halo as jdiag
    from test_torch_partition import fake_mesh
    S = CASES[case]
    want = np.asarray(jdiag(_ref_halo(S, 8)))
    got = np.concatenate([ph.extract_diagonal_halo(ph.build_halo(
        from_scipy(S), fake_mesh(8, r))).numpy() for r in range(8)])
    np.testing.assert_array_equal(got, want)
    assert (got[S.shape[0]:] == 1).all()


def test_halo_ell_refuses_a_transfer_diagonal():
    from test_torch_partition import fake_mesh
    H = ph.build_halo(from_scipy(CASES["transfer97x25"]), fake_mesh(4, 0))
    with pytest.raises(ValueError):
        ph.extract_diagonal_halo(H)


# -- a one-rank gloo group in this process -----------------------------------

@pytest.fixture(scope="module")
def mesh():
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield pt.make_row_mesh(1, device="cpu")
    if made:
        dist.destroy_process_group()


def _sa(n=24, dtype=np.float64, **kw):
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    A = poisson((n, n)).astype(dtype)
    return A, smoothed_aggregation_solver(A, max_coarse=10, **kw)


def test_make_row_mesh_checks_the_group(mesh):
    assert (mesh.size, mesh.rank, mesh.ranks) == (1, 0, (0,))
    with pytest.raises(ValueError, match="2"):
        pt.make_row_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            pt.make_row_mesh()


@pytest.mark.parametrize("spmv", ["gspmd", "halo"])
@pytest.mark.parametrize("accel", [None, "cg", "gmres", "fgmres"])
def test_one_rank_solve_equals_the_unsharded_port(mesh, spmv, accel):
    """On one rank the sharded solve is the unsharded one: histories to
    1e-12, x to 1e-12."""
    A, ml0 = _sa()
    b = np.random.default_rng(1).standard_normal(A.shape[0])
    want = []
    x0 = ml0.to_device("cpu").solve(b, maxiter=8, tol=1e-12, accel=accel,
                                    residuals=want)
    _, ml = _sa()
    pt.shard_hierarchy(ml, mesh, replicate_below=64, spmv=spmv)
    got = []
    x = ml.solve(b, maxiter=8, tol=1e-12, accel=accel, residuals=got)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(x.numpy(), x0.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert x.shape == (A.shape[0],)


@pytest.mark.parametrize("cycle", ["V", "W", "F", "AMLI"])
@pytest.mark.parametrize("spmv", ["gspmd", "halo"])
def test_sharded_cycle_reads_nothing_on_the_host(mesh, spmv, cycle,
                                                 monkeypatch):
    """A sharded cycle, its collectives included, with every host read of
    a tensor patched to raise (and no ``aten::item`` in its profile)."""
    A, ml = _sa()
    pt.shard_hierarchy(ml, mesh, replicate_below=64, spmv=spmv)
    cyc = ml._make_cycle(cycle)
    b = ml._scatter(np.random.default_rng(2).standard_normal(A.shape[0]),
                    torch.float64)
    x = torch.zeros_like(b)
    pt.reset_counts()
    forbid_host_reads(monkeypatch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        x = cyc(x, b)
    monkeypatch.undo()
    assert not [e.name for e in prof.events()
                if e.name in ("aten::item", "aten::_local_scalar_dense")]
    assert bool(torch.isfinite(x).all())
    assert pt.COUNTS["all_gather"] > 0
    # AMLI's level-0 step takes 6 inner products on the sharded level 1
    # (2 + 4 over its two corrections); its level-1 step's are on the
    # replicated level 2
    assert pt.COUNTS["all_reduce"] == (6 if cycle == "AMLI" else 0)


def test_sharded_io_and_entry_points_refuse(mesh, tmp_path):
    from pyamg_tpu_torch.io import save_hierarchy
    A, ml = _sa()
    pt.shard_hierarchy(ml, mesh, replicate_below=64)
    b = np.ones(A.shape[0])
    with pytest.raises(TypeError, match="sharded"):
        save_hierarchy(ml, str(tmp_path / "ml.npz"))
    with pytest.raises(ValueError, match="mesh"):
        ml.to_device("cpu")
    with pytest.raises(NotImplementedError):
        ml.solve_refined_device(b)
    with pytest.raises(NotImplementedError):
        ml.as_dtype(torch.float32)
    # the other Krylov methods run there: their inner products are summed
    # over the ranks
    x = ml.solve(b, accel="bicgstab", maxiter=2)
    assert x.shape == (A.shape[0],) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("spmv", ["gspmd", "halo"])
def test_change_solve_matrix_keeps_the_mesh(mesh, spmv):
    """A new fine matrix on a sharded hierarchy is split as the old one
    was; ``_fine_n`` and the mesh stay, and the solve equals that of a
    hierarchy sharded with the new matrix in place."""
    from pyamg_tpu_torch.relaxation.smoothing import change_smoothers
    from pyamg_tpu_torch.sparse.matrix import ELL
    A, ml = _sa()
    gs = ("gauss_seidel", {"sweep": "symmetric"})
    change_smoothers(ml, gs, gs)
    pt.shard_hierarchy(ml, mesh, replicate_below=64, spmv=spmv)
    A2 = ELL(A.cols, A.vals * 2.0, A.row_nnz, A.shape)
    kind = type(ml.levels[0].A)
    ml.change_solve_matrix(A2)
    assert type(ml.levels[0].A) is kind
    assert ml._fine_n == A.shape[0] and ml._mesh is mesh
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    got = []
    ml.solve(b, maxiter=4, tol=1e-12, residuals=got)
    _, ref = _sa()
    change_smoothers(ref, gs, gs)
    ref.to_device("cpu").change_solve_matrix(A2)
    want = []
    ref.solve(b, maxiter=4, tol=1e-12, residuals=want)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_psolve_takes_and_gives_whole_vectors(mesh):
    A, ml0 = _sa()
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    want = ml0.to_device("cpu").psolve(b)
    _, ml = _sa()
    pt.shard_hierarchy(ml, mesh, replicate_below=64, spmv="halo")
    np.testing.assert_allclose(ml.psolve(b).numpy(), want.numpy(),
                               rtol=1e-12, atol=1e-14)


def test_sharded_diagonals_agree(mesh):
    from pyamg_tpu_torch.ops.spmv import extract_diagonal
    A, _ = _sa()
    for spmv in ("gspmd", "halo"):
        op = pt.shard_operator(A, mesh, spmv)
        np.testing.assert_array_equal(extract_diagonal(op).numpy(),
                                      to_scipy(A).diagonal())
