"""The device form of SpGEMM (``pyamg_tpu_torch/ops/spgemm.py``: ``_expand``,
``_dedup_blocks`` and the tensor branches of ``spgemm``, ``masked_spgemm``
and ``spgemm_bell``) against the JAX package's traced form, run under
``jax.jit`` on the CPU with the same inputs, and against the port's own
host (scipy) form.

The operators: 2-D Poisson 24^2 ``A @ P`` and ``R @ (A @ P)`` of a
smoothed-aggregation hierarchy, a nonsymmetric random pair, a pair with
empty rows, a width-1 pair and 2-D elasticity 10^2 ``A @ P`` (BELL, 2 x 2
by 2 x 3 blocks), each in float64 and float32.  The candidates of
``_expand`` are equal.  Columns and ``row_nnz`` of every product are
equal; the values are differences of running sums, which round otherwise
than scipy's direct sums, so each value is held within 1e-12 (float64) or
1e-5 (float32) of its row's sum of |candidate products|.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu.sparse.matrix import BELL as JBELL, ELL as JELL

from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import linear_elasticity, poisson
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy

ref = importlib.import_module("pyamg_tpu.ops.spgemm")
port = importlib.import_module("pyamg_tpu_torch.ops.spgemm")

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
DTYPES = [np.float64, np.float32]


def _random(rng, n, m, density, empty=()):
    S = sp.random(n, m, density=density, random_state=rng, format="csr")
    S.data = rng.standard_normal(S.nnz)
    for i in empty:
        S.data[S.indptr[i]:S.indptr[i + 1]] = 0
    S.eliminate_zeros()
    return S


def _pairs():
    rng = np.random.default_rng(16)
    ml = smoothed_aggregation_solver(poisson((24, 24)), max_coarse=10)
    lvl = ml.levels[0]
    AP = port.spgemm(lvl.A, lvl.P)
    # one stored entry a row, and rows of A and of B with none
    perm = sp.csr_matrix((rng.standard_normal(30), (np.arange(30),
                          rng.permutation(30))), shape=(30, 30))
    diag = sp.csr_matrix((rng.standard_normal(30), (np.arange(30),
                          np.arange(30))), shape=(30, 30))
    return {
        "poisson A@P": (lvl.A, lvl.P),
        "poisson R@(A@P)": (lvl.R, AP),
        "nonsymmetric": (from_scipy(_random(rng, 40, 30, 0.15)),
                         from_scipy(_random(rng, 30, 25, 0.2))),
        "empty rows": (from_scipy(_random(rng, 30, 30, 0.1, range(0, 30, 4))),
                       from_scipy(_random(rng, 30, 20, 0.15,
                                          range(1, 30, 3)))),
        "width 1": (from_scipy(perm), from_scipy(diag)),
        "width 1 by wider": (from_scipy(perm),
                             from_scipy(_random(rng, 30, 30, 0.2))),
    }


PAIRS = _pairs()


@pytest.fixture(scope="module")
def elasticity():
    A, B = linear_elasticity((10, 10))
    lvl = smoothed_aggregation_solver(A, B=B, max_coarse=50).levels[0]
    return lvl.A, lvl.P


def _jax(M):
    kind = JBELL if M.blocksize != (1, 1) else JELL
    extra = (M.blocksize,) if kind is JBELL else ()
    return kind(jnp.asarray(M.cols), jnp.asarray(M.vals),
                jnp.asarray(M.row_nnz), M.shape, *extra)


def _bound(A, B):
    """Each row's sum of |candidate products|, the scale of its rounding:
    the row sums of |A| @ |B|, ``(n, 1)``, or by block entry for blocks,
    ``(nb, 1, br, bc)``."""
    br, bc = A.blocksize[0], B.blocksize[1]
    C = abs(to_scipy(A).astype(np.float64)) @ \
        abs(to_scipy(B).astype(np.float64))
    m = C.shape[1]
    phase = sp.csr_matrix((np.ones(m), (np.arange(m), np.arange(m) % bc)),
                          shape=(m, bc))
    sums = (C @ phase).toarray()
    return sums if (br, bc) == (1, 1) else sums.reshape(-1, br, bc)[:, None]


def _close(got, want, bound, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert (np.abs(got - want) <= TOL[dtype] * bound).all(), \
        float((np.abs(got - want) / np.maximum(bound, 1e-300)).max())


def _same_product(got, want, bound, dtype):
    """Equal columns and row_nnz, values within the row's bound."""
    assert got.shape == want.shape and got.width == want.width
    for f in ("cols", "row_nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
    _close(got.vals, want.vals, bound, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_expand_matches_reference(pair, dtype):
    A, B = (M.astype(dtype) for M in PAIRS[pair])
    want = jax.jit(ref._expand)(_jax(A), _jax(B))
    got = port._expand(A.to("cpu"), B.to("cpu"))
    assert got[1].dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_spgemm_matches_reference_and_host(pair, dtype):
    """Against the JAX package's traced product (its width given, as a
    traced product cannot read it) and against the port's scipy product;
    the port's tensors stay on their device."""
    A, B = (M.astype(dtype) for M in PAIRS[pair])
    host = port.spgemm(A, B)
    assert isinstance(host.vals, np.ndarray)
    width = host.width
    want = jax.jit(lambda a, b: ref.spgemm(a, b, width=width))(_jax(A),
                                                                _jax(B))
    got = port.spgemm(A.to("cpu"), B.to("cpu"))
    assert isinstance(got.vals, torch.Tensor)
    bound = _bound(A, B)
    _same_product(got, want, bound, dtype)
    _same_product(got, host, bound, dtype)
    # a host operand goes to the other's device
    mixed = port.spgemm(A, B.to("cpu"))
    assert isinstance(mixed.cols, torch.Tensor)
    _same_product(mixed, got, bound, dtype)


def _pattern(A, B, rng):
    """A column-sorted pattern of A @ B's shape: part of the product's
    pattern and columns it does not reach, a zero-padded tail."""
    C = port.spgemm(A, B)
    n, m = C.shape
    W = C.width + 3
    cols = np.zeros((n, W), np.int32)
    valid = np.zeros((n, W), bool)
    for i in range(n):
        have = C.cols[i, :C.row_nnz[i]]
        pick = set(have[rng.random(len(have)) < 0.7].tolist())
        pick |= set(rng.integers(0, m, 3).tolist())
        row = np.sort(np.fromiter(pick, np.int64))[:W]
        cols[i, :len(row)] = row
        valid[i, :len(row)] = True
    return cols, valid


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
@pytest.mark.parametrize("pair", list(PAIRS))
def test_masked_spgemm_matches_reference_and_host(pair, dtype):
    A, B = (M.astype(dtype) for M in PAIRS[pair])
    pc, pv = _pattern(A, B, np.random.default_rng(7))
    want = jax.jit(ref.masked_spgemm)(_jax(A), _jax(B), jnp.asarray(pc),
                                      jnp.asarray(pv))
    host = port.masked_spgemm(A, B, pc, pv)
    assert isinstance(host, np.ndarray)
    bound = _bound(A, B)
    got = port.masked_spgemm(A.to("cpu"), B.to("cpu"), pc, pv)
    _close(got.numpy(), want, bound, dtype)
    _close(got.numpy(), host, bound, dtype)
    # the pattern alone on a device takes the device form there
    got = port.masked_spgemm(A, B, torch.as_tensor(pc), pv)
    _close(got.numpy(), host, bound, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_spgemm_bell_matches_reference_and_host(elasticity, dtype):
    A, P = (M.astype(dtype) for M in elasticity)
    assert (A.blocksize, P.blocksize) == ((2, 2), (2, 3))
    host = port.spgemm_bell(A, P)
    assert isinstance(host.vals, np.ndarray)
    width = host.width
    want = jax.jit(lambda a, b: ref.spgemm_bell(a, b, width=width))(
        _jax(A), _jax(P))
    got = port.spgemm_bell(A.to("cpu"), P.to("cpu"))
    assert isinstance(got.vals, torch.Tensor) and got.blocksize == (2, 3)
    bound = _bound(A, P)
    _same_product(got, want, bound, dtype)
    _same_product(got, host, bound, dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: d.__name__)
def test_dedup_blocks_matches_reference(elasticity, dtype):
    """The block coalesce alone, on the elasticity candidates."""
    A, P = (M.astype(dtype) for M in elasticity)
    At, Pt = A.to("cpu"), P.to("cpu")
    cols, ok, bv = port._gather_rows(At, Pt)
    vals = torch.einsum("nwij,nwvjk->nwvik", At.vals, bv)
    nb = A.n_block_rows
    args = (cols.reshape(nb, -1), vals.reshape((nb, -1) + (2, 3)),
            ok.reshape(nb, -1))
    want = jax.jit(ref._dedup_blocks, static_argnums=3)(
        *(jnp.asarray(a.numpy()) for a in args), P.n_block_cols)
    got = port._dedup_blocks(*args, P.n_block_cols)
    for i in (0, 2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _close(got[1].numpy(), want[1], _bound(A, P), dtype)
