"""The port's row partitions (``pyamg_tpu_torch/parallel/partition.py``)
against the JAX package's (``pyamg_tpu/parallel/partition.py``), array for
array, on the cases of ``tests/test_halo.py``.

Nothing here communicates: a ``RowMesh`` of any size can be named for one
rank at a time, and a rank's gathered input is the whole padded vector,
so every rank's block and product is checked in one process.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.gallery import poisson as jpoisson, sprand as jsprand
from pyamg_tpu.sparse.matrix import to_scipy as jto_scipy

from pyamg_tpu_torch.parallel import partition as pt
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy

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
            "poisson40": jto_scipy(jpoisson((40,))).tocsr()}


CASES = _cases()


def _both(S):
    """(the JAX package's ELL, the port's) of one scipy matrix."""
    from pyamg_tpu.sparse.matrix import from_scipy as jfrom_scipy
    return jfrom_scipy(S), from_scipy(S)


def _same_ell(got, want):
    np.testing.assert_array_equal(np.asarray(got.cols), np.asarray(want.cols))
    np.testing.assert_array_equal(np.asarray(got.vals), np.asarray(want.vals))
    np.testing.assert_array_equal(np.asarray(got.row_nnz),
                                  np.asarray(want.row_nnz))
    assert tuple(got.shape) == tuple(want.shape)


def fake_mesh(size, rank):
    """A mesh of ``size`` ranks seen from ``rank``, with no process
    group: enough for everything but the collectives."""
    return pt.RowMesh(None, size, rank, torch.device("cpu"),
                      tuple(range(size)))


@pytest.mark.parametrize("identity_pad", [True, False])
@pytest.mark.parametrize("multiple", [3, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_pad_matrix_rows_matches(case, multiple, identity_pad):
    from pyamg_tpu.parallel.partition import pad_matrix_rows
    jA, A = _both(CASES[case])
    _same_ell(pt.pad_matrix_rows(A, multiple, identity_pad),
              pad_matrix_rows(jA, multiple, identity_pad))


@pytest.mark.parametrize("multiple", [4, 8])
@pytest.mark.parametrize("case", ["poisson23x17", "sprand150", "poisson40"])
def test_pad_square_matches(case, multiple):
    from pyamg_tpu.parallel.partition import _pad_square
    jA, A = _both(CASES[case])
    _same_ell(pt._pad_square(A, multiple), _pad_square(jA, multiple))


def test_pad_square_refuses_a_transfer():
    with pytest.raises(ValueError):
        pt._pad_square(from_scipy(_transfer()), 4)


def _hierarchies(n=(23, 17)):
    from pyamg_tpu.aggregation import smoothed_aggregation_solver as jsa
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    return jsa(jpoisson(n), max_coarse=10), \
        smoothed_aggregation_solver(poisson(n), max_coarse=10)


@pytest.mark.parametrize("ndev", [4, 8])
def test_padded_smoother_vectors_match(ndev):
    """Every level's smoother arrays padded as the JAX package's
    ``_shard_params`` pads them (colors -1, Dinv 0), array for array."""
    from pyamg_tpu.parallel import make_row_mesh
    from pyamg_tpu.parallel.partition import _shard_params
    jml, ml = _hierarchies()
    mesh = make_row_mesh(ndev)
    padded = 0
    for jl, l in zip(jml.levels, ml.levels):
        n = l.A.shape[0]
        for attr in ("pre", "post"):
            want = _shard_params(getattr(jl, attr)[2], n, ndev, mesh)
            got = pt._pad_params(getattr(l, attr)[2], n, ndev)
            assert set(got) == set(want)
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[k]),
                                              np.asarray(v), err_msg=k)
                if k == "colors" and n % ndev:
                    assert (np.asarray(got[k])[n:] == -1).all()
                    padded += 1
    assert padded, "no level pads at this size"


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_matrix_blocks_and_products(case):
    """Each rank's block of the padded rows, with global columns; its
    product on the gathered (whole padded) input gives the rank's rows
    of the unsharded product bit for bit."""
    A = from_scipy(CASES[case])
    ndev = 4
    square = A.shape[0] == A.shape[1]
    Ap = pt._pad_square(A, ndev) if square else \
        pt.pad_matrix_rows(A, ndev, identity_pad=False)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        Ap.shape[1]))
    want = torch.sum(torch.as_tensor(Ap.vals) *
                     x[torch.as_tensor(Ap.cols).long()], dim=1)
    blocks, ys = [], []
    for r in range(ndev):
        S = pt.shard_matrix(Ap, fake_mesh(ndev, r), in_sharded=False)
        assert S.shape == Ap.shape and S.nnz == Ap.nnz
        blocks.append(S.local.cols.numpy())
        ys.append(S.mv(x))
    np.testing.assert_array_equal(np.concatenate(blocks), Ap.cols)
    assert torch.equal(torch.cat(ys), want)
    np.testing.assert_allclose(
        torch.cat(ys).numpy()[:A.shape[0]],
        to_scipy(A) @ x.numpy()[:A.shape[1]], rtol=1e-12, atol=1e-12)


def test_shard_matrix_needs_whole_blocks():
    A = from_scipy(CASES["poisson40"].tocsr()[:39, :39])
    with pytest.raises(ValueError, match="pad"):
        pt.shard_matrix(A, fake_mesh(4, 0))


@pytest.mark.parametrize("case", ["poisson23x17", "poisson40"])
def test_sharded_diagonal(case):
    A = from_scipy(CASES[case])
    Ap = pt._pad_square(A, 8)
    d = torch.cat([pt.shard_matrix(Ap, fake_mesh(8, r)).diagonal()
                   for r in range(8)])
    np.testing.assert_array_equal(d.numpy()[:A.shape[0]],
                                  CASES[case].diagonal())
    assert (d.numpy()[A.shape[0]:] == 1).all()


def test_shard_vector_pads_and_splits():
    v = np.arange(10.0)
    blocks = [pt.shard_vector(v, fake_mesh(4, r)) for r in range(4)]
    assert all(b.shape == (3,) for b in blocks)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(),
                                  np.r_[v, 0.0, 0.0])
    np.testing.assert_array_equal(pt._pad_vec(np.arange(5), 4, "colors"),
                                  [0, 1, 2, 3, 4, -1, -1, -1])


@pytest.mark.parametrize("spmv", ["gspmd", "halo"])
def test_shard_hierarchy_structure(spmv):
    """Which levels are sharded (more than replicate_below rows and an
    ELL), each operator's input and output split, the padded rows, and
    every rank's smoother blocks laid end to end equal the padded
    arrays."""
    from pyamg_tpu_torch.parallel import HaloELL, ShardedELL
    ndev, rb = 4, 64
    mls = []
    for r in range(ndev):
        _, ml = _hierarchies((24, 24))
        mls.append(pt.shard_hierarchy(ml, fake_mesh(ndev, r),
                                      replicate_below=rb, spmv=spmv))
    _, ref = _hierarchies((24, 24))
    rows = [l.A.shape[0] for l in ref.levels]
    assert rows == [576, 102, 12, 2]
    ml = mls[0]
    assert ml._fine_n == 576 and ml.device == torch.device("cpu")
    kind = HaloELL if spmv == "halo" else ShardedELL
    assert [type(l.A) for l in ml.levels[:2]] == [kind, kind]
    assert [l.A.shape[0] for l in ml.levels] == [576, 104, 12, 2]
    P0, R0, P1, R1 = (ml.levels[0].P, ml.levels[0].R, ml.levels[1].P,
                      ml.levels[1].R)
    assert (P0.in_sharded, P0.out_sharded) == (True, True)
    assert (R0.in_sharded, R0.out_sharded) == (True, True)
    assert (P1.in_sharded, P1.out_sharded) == (False, True)
    assert (R1.in_sharded, R1.out_sharded) == (True, False)
    assert R1.local.shape[0] == 12
    for i in (0, 1):
        n = rows[i]
        want = pt._pad_params(ref.levels[i].pre[2], n, ndev)
        for k, v in want.items():
            if isinstance(v, np.ndarray) and v.ndim:
                got = np.concatenate([m.levels[i].pre[2][k].numpy()
                                      for m in mls])
                np.testing.assert_array_equal(got, v, err_msg=k)
    assert isinstance(ml.levels[2].A.cols, torch.Tensor)


def test_shard_hierarchy_refuses_what_it_cannot_split():
    from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
    from pyamg_tpu_torch.gallery import poisson
    sz = ("schwarz", {})
    ml = smoothed_aggregation_solver(poisson((24, 24)), max_coarse=10,
                                     presmoother=sz, postsmoother=sz)
    with pytest.raises(TypeError, match="schwarz"):
        pt.shard_hierarchy(ml, fake_mesh(4, 0), replicate_below=64)
    ml = smoothed_aggregation_solver(poisson((24, 24)), max_coarse=10)
    with pytest.raises(NotImplementedError, match="coarsest"):
        pt.shard_hierarchy(ml, fake_mesh(4, 0), replicate_below=1)
    with pytest.raises(ValueError, match="spmv"):
        pt.shard_hierarchy(ml, fake_mesh(4, 0), spmv="ring")
    from pyamg_tpu_torch.sparse.matrix import dia_from_ell
    D = dia_from_ell(from_scipy(CASES["poisson40"]))
    with pytest.raises(TypeError, match="compress_stencils"):
        pt._transfer(D, fake_mesh(4, 0), rows_sharded=True, in_sharded=True)


def test_make_row_mesh_needs_an_initialised_group(monkeypatch):
    import torch.distributed as dist
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="init_process_group"):
        pt.make_row_mesh(4, device="cpu")
