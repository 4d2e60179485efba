"""The port's block (BELL) operator against the JAX package's, on the CPU:
the container and its scipy round trips, ``bspmv`` on the host and as
torch ops, the block diagonal, ``btranspose``, ``spgemm_bell``,
``pinv_array``, the BSR row helpers and the block forms of strength of
connection.

Tolerances: the host paths run the same numpy/scipy arithmetic as the
JAX package's host paths and are held equal.  The device form of
``bspmv`` (a gather and one einsum in torch, on CPU tensors here) is held
to the JAX package's jitted gather-and-einsum and to scipy's BSR product
within 1e-12 of the largest entry in float64 and 1e-6 in float32 (the
contraction's order of additions is the library's).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.ops.spgemm import spgemm_bell as ref_spgemm_bell
from pyamg_tpu.ops.spmv import bspmv as ref_bspmv
from pyamg_tpu.ops.spmv import extract_block_diagonal as ref_block_diagonal
from pyamg_tpu.ops.spmv import extract_diagonal as ref_extract_diagonal
from pyamg_tpu.ops.transpose import btranspose as ref_btranspose
from pyamg_tpu.sparse.matrix import BELL as RefBELL
from pyamg_tpu.sparse.matrix import bell_from_scipy as ref_bell_from_scipy
from pyamg_tpu.sparse.matrix import from_scipy as ref_from_scipy
from pyamg_tpu.sparse.matrix import to_scipy as ref_to_scipy
from pyamg_tpu.strength import _block_reduce as ref_block_reduce
from pyamg_tpu.strength import strength_measure as ref_strength_measure
from pyamg_tpu.strength import \
    symmetric_strength_of_connection as ref_symmetric_soc
from pyamg_tpu.util import bsr_utils as ref_bsr_utils
from pyamg_tpu.util.linalg import pinv_array as ref_pinv_array

from pyamg_tpu_torch.ops.spgemm import spgemm_bell
from pyamg_tpu_torch.ops.spmv import (bspmv, extract_block_diagonal,
                                      extract_diagonal, matvec)
from pyamg_tpu_torch.ops.transpose import btranspose
from pyamg_tpu_torch.sparse.matrix import (BELL, ELL, asarray_or_ell,
                                           bell_from_scipy, from_scipy,
                                           to_scipy)
from pyamg_tpu_torch.strength import (_block_reduce, strength_measure,
                                      symmetric_strength_of_connection)
from pyamg_tpu_torch.util import bsr_utils
from pyamg_tpu_torch.util.linalg import pinv_array

torch.set_num_threads(1)

TOL = {np.float32: 1e-6, np.float64: 1e-12}
BLOCKS = [(2, 2), (3, 3), (2, 3), (3, 1)]


def _bsr(nb=30, mb=None, blocksize=(2, 2), dtype=np.float64, seed=0,
         complex_=False):
    """A random (nb x mb)-block BSR matrix with about 4 blocks a block row
    and, when square, every diagonal block stored (one of them zero)."""
    mb = nb if mb is None else mb
    rng = np.random.default_rng(seed)
    br, bc = blocksize
    P = sp.random(nb, mb, density=min(1.0, 4.0 / mb), random_state=rng,
                  format="csr")
    if nb == mb:
        P = P + sp.eye(nb)
    P = P.tocsr()
    P.sort_indices()
    data = rng.standard_normal((P.nnz, br, bc))
    if complex_:
        data = data + 1j * rng.standard_normal((P.nnz, br, bc))
    if nb == mb:          # a zero diagonal block on block row 3
        k = P.indptr[3] + int(np.flatnonzero(P.indices[P.indptr[3]:
                                                         P.indptr[4]] == 3)[0])
        data[k] = 0
    return sp.bsr_matrix((data.astype(dtype if not complex_ else
                                      np.complex128), P.indices, P.indptr),
                         shape=(nb * br, mb * bc))


def _same_bell(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    assert tuple(got.blocksize) == tuple(want.blocksize)
    np.testing.assert_array_equal(np.asarray(got.row_nnz),
                                  np.asarray(want.row_nnz))
    np.testing.assert_array_equal(np.asarray(got.cols),
                                  np.asarray(want.cols))
    gv, wv = np.asarray(got.vals), np.asarray(want.vals)
    assert gv.dtype == wv.dtype
    np.testing.assert_array_equal(gv, wv)


def _same_ell(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.row_nnz, np.asarray(want.row_nnz))
    mask = got.valid_mask()
    np.testing.assert_array_equal(got.cols[mask], np.asarray(want.cols)[mask])
    gv, wv = got.vals[mask], np.asarray(want.vals)[mask]
    assert gv.dtype == wv.dtype
    np.testing.assert_array_equal(gv, wv)


# -- the container -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("blocksize", BLOCKS)
def test_bell_round_trips_through_scipy(blocksize, dtype):
    S = _bsr(blocksize=blocksize, dtype=dtype)
    A = from_scipy(S)
    assert isinstance(A, BELL)
    _same_bell(A, ref_from_scipy(S))
    _same_bell(bell_from_scipy(S, width=A.width + 2),
               ref_bell_from_scipy(S, width=A.width + 2))
    back = to_scipy(A)
    assert back.format == "bsr" and back.blocksize == blocksize
    np.testing.assert_array_equal(back.toarray(), S.toarray())
    np.testing.assert_array_equal(back.toarray(),
                                  ref_to_scipy(ref_from_scipy(S)).toarray())
    assert A.nnz == ref_from_scipy(S).nnz == S.nnz
    np.testing.assert_array_equal(A.valid_mask(),
                                  np.asarray(ref_from_scipy(S).valid_mask()))
    assert A.n_block_rows == S.shape[0] // blocksize[0]
    assert A.n_block_cols == S.shape[1] // blocksize[1]


def test_bell_converts_places_and_casts():
    S = _bsr()
    A = asarray_or_ell(S, np.float32)
    assert isinstance(A, BELL) and A.dtype == np.float32
    assert asarray_or_ell(A) is A
    assert isinstance(asarray_or_ell(S.tocsr()), ELL)
    assert isinstance(from_scipy(S.tobsr((1, 1))), ELL)
    T = A.to("cpu")
    assert T.cols.dtype == torch.long and T.row_nnz.dtype == torch.int32
    assert T.vals.dtype == torch.float32 and T.vals.shape == A.vals.shape
    assert T.nnz == A.nnz
    assert "BELL" in repr(A) and "(2, 2)" in repr(A)


# -- products ------------------------------------------------------------------

@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("blocksize", BLOCKS)
def test_bspmv_on_the_host_matches_reference(blocksize, k):
    S = _bsr(blocksize=blocksize)
    A, Ar = from_scipy(S), ref_from_scipy(S)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(S.shape[1] if k is None else (S.shape[1], k))
    np.testing.assert_array_equal(bspmv(A, x), ref_bspmv(Ar, x))
    np.testing.assert_array_equal(matvec(A, x), S @ x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [None, 2])
@pytest.mark.parametrize("blocksize", BLOCKS)
def test_bspmv_as_torch_ops_matches_reference(blocksize, k, dtype):
    S = _bsr(blocksize=blocksize, dtype=dtype)
    A = from_scipy(S)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(S.shape[1] if k is None else
                            (S.shape[1], k)).astype(dtype)
    got = bspmv(A.to("cpu"), torch.as_tensor(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == \
        (S.shape[0],) + (() if k is None else (k,))
    Aj = RefBELL(jnp.asarray(A.cols), jnp.asarray(A.vals),
                 jnp.asarray(A.row_nnz), A.shape, A.blocksize)
    want = np.asarray(jax.jit(ref_bspmv)(Aj, jnp.asarray(x)))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= TOL[dtype] * scale
    assert np.abs(got.numpy() - S @ x).max() <= TOL[dtype] * scale
    assert torch.equal(matvec(A.to("cpu"), torch.as_tensor(x)), got)


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("blocksize", [(2, 2), (3, 3)])
def test_block_diagonal_matches_reference(blocksize, placed):
    S = _bsr(blocksize=blocksize)
    A, Ar = from_scipy(S), ref_from_scipy(S)
    op = A.to("cpu") if placed else A
    D, d = extract_block_diagonal(op), extract_diagonal(op)
    D, d = (np.asarray(v) for v in (D, d))
    np.testing.assert_array_equal(D, np.asarray(ref_block_diagonal(Ar)))
    np.testing.assert_array_equal(d, np.asarray(ref_extract_diagonal(Ar)))
    np.testing.assert_array_equal(d, S.diagonal())
    assert not D[3].any()
    with pytest.raises(ValueError):
        extract_diagonal(from_scipy(_bsr(blocksize=(2, 3))))


@pytest.mark.parametrize("conjugate", [False, True])
@pytest.mark.parametrize("blocksize", BLOCKS)
def test_btranspose_matches_reference(blocksize, conjugate):
    S = _bsr(nb=20, mb=13, blocksize=blocksize, complex_=conjugate)
    A, Ar = from_scipy(S), ref_from_scipy(S)
    T = btranspose(A, conjugate=conjugate)
    _same_bell(T, ref_btranspose(Ar, conjugate=conjugate))
    want = S.conj().T if conjugate else S.T
    np.testing.assert_array_equal(to_scipy(T).toarray(), want.toarray())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sizes", [((2, 2), (2, 3)), ((3, 2), (2, 2)),
                                   ((3, 3), (3, 3)), ((1, 1), (1, 3))])
def test_spgemm_bell_matches_reference(sizes, dtype):
    (ba, bb) = sizes
    SA = _bsr(nb=18, mb=15, blocksize=ba, dtype=dtype, seed=3)
    SB = _bsr(nb=15, mb=11, blocksize=bb, dtype=dtype, seed=4)
    C = spgemm_bell(bell_from_scipy(SA), from_scipy(SB))
    _same_bell(C, ref_spgemm_bell(ref_bell_from_scipy(SA),
                                  ref_from_scipy(SB)))
    assert C.blocksize == (ba[0], bb[1])
    with pytest.raises(ValueError):
        spgemm_bell(from_scipy(SB), from_scipy(SB))


def test_pinv_array_matches_reference():
    rng = np.random.default_rng(5)
    blocks = rng.standard_normal((40, 3, 3))
    blocks[3] = 0
    blocks[7, 2] = blocks[7, 0] + blocks[7, 1]          # singular
    np.testing.assert_array_equal(pinv_array(blocks),
                                  np.asarray(ref_pinv_array(blocks)))
    ones = rng.standard_normal((10, 1, 1)).astype(np.float32)
    ones[4] = 0
    got = pinv_array(ones)
    np.testing.assert_array_equal(got, np.asarray(ref_pinv_array(ones)))
    assert got.dtype == np.float32 and got[4, 0, 0] == 0


# -- BSR row helpers -----------------------------------------------------------

@pytest.mark.parametrize("row", [0, 7, 21])
def test_bsr_row_helpers_match_reference(row):
    S = _bsr(nb=12, mb=12, blocksize=(2, 3))
    A, Ar = from_scipy(S), ref_from_scipy(S)
    for got, want in zip(bsr_utils.bsr_getrow(A, row),
                         ref_bsr_utils.bsr_getrow(Ar, row)):
        np.testing.assert_array_equal(got, want)
    _same_bell(bsr_utils.bsr_row_setscalar(A, row, 2.5),
               ref_bsr_utils.bsr_row_setscalar(Ar, row, 2.5))
    x = np.arange(S.shape[1], dtype=float)
    _same_bell(bsr_utils.bsr_row_setvector(A, row, x),
               ref_bsr_utils.bsr_row_setvector(Ar, row, x))


# -- block strength ------------------------------------------------------------

@pytest.mark.parametrize("norm", ["abs", "min", "fro"])
@pytest.mark.parametrize("blocksize", [(2, 2), (3, 3)])
def test_block_reduce_matches_reference(blocksize, norm):
    S = _bsr(blocksize=blocksize)
    _same_ell(_block_reduce(from_scipy(S), norm),
              ref_block_reduce(ref_from_scipy(S), norm))
    with pytest.raises(ValueError):
        _block_reduce(from_scipy(S), "max")


@pytest.mark.parametrize("theta", [0.0, 0.1, 0.5])
def test_block_symmetric_strength_matches_reference(theta):
    from pyamg_tpu_torch.gallery import linear_elasticity
    from pyamg_tpu.gallery import linear_elasticity as ref_elasticity
    A, _ = linear_elasticity((7, 6))
    Ar, _ = ref_elasticity((7, 6))
    _same_ell(symmetric_strength_of_connection(A, theta),
              ref_symmetric_soc(Ar, theta))
    _same_ell(strength_measure(A, ("symmetric", {"theta": theta})),
              ref_strength_measure(Ar, ("symmetric", {"theta": theta})))


def test_block_strength_of_no_measure_matches_reference():
    S = _bsr(blocksize=(2, 2))
    _same_ell(strength_measure(from_scipy(S), None),
              ref_strength_measure(ref_from_scipy(S), None))
