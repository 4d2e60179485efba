"""K1's launch geometry (``ops/dia_kernels.spmv_geometry``) and its row
walk, replayed on the CPU.

The launch covers every (row, column) of y exactly once, for n from 1 to
past one wave of 132 SMs, any k, float32 and float64, and an ``npad``
that is or is not a multiple of the rows a thread; a row group that the
kernel loads as one 16-byte vector starts on a 16-byte boundary.

Then the kernel's walk is emulated in torch, as ``csrc/dia_kernels.cu``
does it: each thread reads its row group of every diagonal as one vector
(or value by value, masked to rows < n, where ``npad`` is not a multiple
of the rows a thread), the x values of its rows and column masked to
[0, n), adds the products in diagonal order and stores its rows below n.
Rows past n hold NaN in the band.  The result must equal
``dia_spmv_plain`` bit for bit, inf and NaN included.
"""

import numpy as np
import pytest
import torch

from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.gallery import poisson
from pyamg_tpu_torch.ops import dia_kernels as dk
from pyamg_tpu_torch.sparse.matrix import DIA_TILE, dia_from_ell

torch.set_num_threads(1)

SMS = 132
ONE_WAVE = SMS * dk.SPMV_THREADS * 4      # float32 rows of full blocks


def _threads(g, n, k):
    """(column, first row, end row) of every thread of the launch, as
    numpy arrays."""
    t = np.arange(g.blocks * g.threads)
    grp, c = t // k, t % k
    return c, np.minimum(n, grp * g.rows), np.minimum(n, (grp + 1) * g.rows)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 31, 127, 1000, 4223, 27_889,
                               ONE_WAVE - 1, ONE_WAVE + 5, 250_000])
def test_geometry_covers_every_row_once(n, k, itemsize):
    rows = 16 // itemsize
    for npad in {n, n + 1, -(-n // rows) * rows,
                 -(-n // DIA_TILE) * DIA_TILE}:
        g = dk.spmv_geometry(n, k, npad, itemsize, SMS)
        assert g.rows == rows and g.vector == (npad % rows == 0)
        work = -(-n // rows) * k
        # the launch shapes the CUDA entry point accepts
        assert 32 <= g.threads <= dk.SPMV_THREADS and g.threads % 32 == 0
        assert (g.blocks - 1) * g.threads < work <= g.blocks * g.threads
        if work >= 32 * SMS:            # spread over every SM
            assert g.blocks >= SMS
        c, a, e = _threads(g, n, k)
        count = np.zeros(n * k, np.int64)
        for r in range(rows):
            live = a + r < e
            np.add.at(count, (a[live] + r) * k + c[live], 1)
        assert (count == 1).all()


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("n, npad", [(250_000, 253_952), (27_889, 32_768),
                                     (4223, 4224), (5, 8)])
def test_vector_rows_are_aligned(n, npad, itemsize):
    g = dk.spmv_geometry(n, 1, npad, itemsize, SMS)
    assert g.vector
    _, a, e = _threads(g, n, 1)
    a = a[a < e]
    for d in range(3):              # every diagonal's row group, 16 bytes
        assert ((d * npad + a) * itemsize % 16 == 0).all()


def _emulate(g, data, offsets, n, x):
    """K1's walk in geometry g: what each thread of dia_spmv_kernel stores,
    in a y that starts as NaN."""
    k = 1 if x.ndim == 1 else x.shape[1]
    xf = x.reshape(-1)
    y = torch.full((n * k,), float("nan"), dtype=x.dtype)
    c, a, e = (torch.as_tensor(v) for v in _threads(g, n, k))
    live = a < e
    c, i0 = c[live], a[live]
    rows = i0[:, None] + torch.arange(g.rows)       # (threads, rows)
    zero = torch.zeros((), dtype=x.dtype)
    acc = None
    for d, off in enumerate(offsets):
        # the band: a 16-byte vector (rows past n within npad), or values
        # masked to rows < n
        band = data[d][rows.clamp(max=data.shape[1] - 1)]
        if g.vector:
            assert (rows < data.shape[1]).all()
        else:
            band = torch.where(rows < n, band, zero)
        j = rows + off
        xv = torch.where((j >= 0) & (j < n),
                         xf[j.clamp(0, n - 1) * k + c[:, None]], zero)
        term = band * xv
        acc = term if acc is None else acc + term
    store = rows < n
    y[(rows * k + c[:, None])[store]] = acc[store]
    return y.reshape(x.shape)


def _nan_padded(band, n, npad, dtype):
    """The band as ``(ndiag, npad)`` of ``dtype``, NaN past row n."""
    data = torch.full((band.shape[0], npad), float("nan"), dtype=dtype)
    data[:, :n] = torch.as_tensor(np.asarray(band)[:, :n]).to(dtype)
    return data


def _operators():
    """(name, band, offsets, n) at 48^2 levels 0 and 1 of the grid-SA
    hierarchy, a band of 80 diagonals and a one-sided band."""
    ml = smoothed_aggregation_solver(poisson((48, 48)).astype(np.float32),
                                     aggregate=("grid", {}), max_coarse=10)
    out = []
    for i, lvl in enumerate(ml.levels[:2]):
        D = dia_from_ell(lvl.A)
        out.append((f"48^2 level {i}", D.data, D.offsets, D.shape[0]))
    rng = np.random.default_rng(80)
    n = 2000
    wide = sorted({0, *rng.choice(np.arange(-250, 251), 79,
                                  replace=False).tolist()})
    while len(wide) < 80:
        wide = sorted({*wide, int(rng.integers(-250, 251))})
    out.append(("80 diagonals", rng.standard_normal((80, n)), tuple(wide), n))
    out.append(("one-sided", rng.standard_normal((4, 3001)),
                (-1500, -40, -1, 0), 3001))
    return out


@pytest.fixture(scope="module")
def operators():
    return _operators()


@pytest.mark.parametrize("op", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", [1, 3])
def test_row_walk_equals_plain(operators, op, dtype, k):
    name, band, offsets, n = operators[op]
    rng = np.random.default_rng(op + 10 * k)
    shape = (n,) if k == 1 else (n, k)
    x = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    xn = x.clone()                      # an inf and a NaN in x
    xn[n // 3] = float("inf")
    xn[2 * n // 3] = float("nan")
    rows = 16 // x.element_size()
    for npad in (-(-n // DIA_TILE) * DIA_TILE, n + 1 if n % rows else n + 2):
        data = _nan_padded(band, n, npad, dtype)
        for sms in (1, 7, SMS):
            g = dk.spmv_geometry(n, k, npad, x.element_size(), sms)
            for xv in (x, xn):
                want = dk.dia_spmv_plain(data, offsets, n, xv)
                got = _emulate(g, data, offsets, n, xv)
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True,
                                           msg=(name, npad, g))


def test_main_path_geometry():
    """The main paths' K1 shapes: 500^2 levels 0 and 1 and 64^3 A0 spread
    over every SM, with 16-byte band rows."""
    for n, npad in ((250_000, 253_952), (27_889, 32_768),
                    (262_144, 262_144)):
        g = dk.spmv_geometry(n, 1, npad, 4, SMS)
        assert g.vector and g.rows == 4 and g.blocks >= SMS
    # level 1 (6,973 threads) in blocks of one warp
    assert dk.spmv_geometry(27_889, 1, 32_768, 4, SMS).threads == 32
