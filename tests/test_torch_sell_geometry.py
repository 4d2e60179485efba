"""The launch geometry of the SELL kernels K3/K4 and K5, on the CPU.

``ops/sell_kernels.py`` computes each launch's shape in Python
(``spmv_geometry``, ``gs_geometry``) and replays the kernels' index
arithmetic on it (``spmv_schedule``, ``gs_schedule``).  For each plan
these checks hold: every (pass, row) slot's product is computed exactly
once, each row's sum runs in pass order (the plain version's), the
dynamic shared memory fits a block of the H100, the cluster is no larger
than the portable 8, and K5 keeps x in shared memory exactly when its
size lets it.  The plans are the six of the 3-D Poisson 64^3 path (by
their sizes, as ``chip_smoke.py`` checks them on the card), small plans
built here as ``tests/test_torch_sell.py`` builds them, a synthetic deep
fat plan, the 2-D Poisson 1800^2 plan's sizes (x past shared memory), and
the classical paths' busiest plans, built here from the port's own
hierarchies at full size (Ruge-Stuben on 2-D Poisson 500^2: P0, R0, A3
and A4; AIR on 2-D advection 256^2: R0, lAIR's restriction).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pyamg_tpu_torch.aggregation import smoothed_aggregation_solver
from pyamg_tpu_torch.classical import air_solver, ruge_stuben_solver
from pyamg_tpu_torch.gallery import advection_2d, poisson
from pyamg_tpu_torch.ops import sell_kernels as sk
from pyamg_tpu_torch.sparse.matrix import from_scipy, to_scipy
from pyamg_tpu_torch.sparse.sell import LANE, SELL, sell_from_ell

torch.set_num_threads(1)

# (passes, rows n, padded rows Sy * 128, square) of the 64^3 path's plans
# (chip_smoke.SELL_64 and the operators' shapes), the 1800^2 plan's rows
# and a deep fat plan with few rows
SIZES = {
    "64^3 P0": (13, 262144, 2048 * LANE, False),
    "64^3 R0": (152, 31868, 256 * LANE, False),
    "64^3 A1": (66, 31868, 256 * LANE, True),
    "64^3 P1": (11, 31868, 328 * LANE, False),
    "64^3 R1": (839, 768, 8 * LANE, False),
    "64^3 A2": (89, 768, 8 * LANE, True),
    "1800^2": (5, 1800 * 1800, 25600 * LANE, True),
    "deep fat": (2000, 256, 8 * LANE, False),
}
BUILT = ["square48", "tall", "fat", "24^3 P0", "24^3 R0", "24^3 A1",
         "24^3 P1"]
# (kind, t, passes, Sy) of the classical paths' plans, as the JAX package
# builds them (tests/jax_classical_reference.py)
CLASSICAL = {"RS P0": ("tall", 2, 5, 1960), "RS R0": ("fat", 2, 7, 984),
             "RS A3": ("tall", 1, 14, 64), "RS A4": ("tall", 1, 13, 16),
             "AIR R0": ("fat", 3, 24, 192)}
SPMV_PLANS = [k for k in SIZES if k != "1800^2"] + BUILT + list(CLASSICAL)
GS_PLANS = [k for k, v in SIZES.items() if v[3]] + ["square48", "24^3 A1",
                                                    "RS A3", "RS A4"]
CHECKS = ["coverage", "pass_order", "shared_memory", "cluster"]


def _size(plan: SELL):
    return (plan.n_passes, plan.shape[0], plan.Sy * LANE, plan.square)


@pytest.fixture(scope="module")
def sizes():
    """SIZES and the sizes of the plans built here."""
    rng = np.random.default_rng(0)
    A = to_scipy(poisson((48, 48))).tolil()
    idx = rng.integers(0, A.shape[0], size=120)
    for i, j in zip(idx[::2], idx[1::2]):
        A[int(i), int(j)] = rng.standard_normal()
    n, m = 1024, 256
    rows = np.repeat(np.arange(n), 2)
    cols = np.concatenate([np.clip(np.arange(n) // 4, 0, m - 1),
                           np.clip(np.arange(n) // 4 + 1, 0, m - 1)])
    tall = sp.csr_matrix((rng.standard_normal(2 * n).astype(np.float32),
                          (rows, cols)), shape=(n, m))
    ops = {"square48": sp.csr_matrix(A.astype(np.float32)), "tall": tall,
           "fat": tall.T.tocsr()}
    out = dict(SIZES)
    for name, S in ops.items():
        out[name] = _size(sell_from_ell(from_scipy(S)))
    ml = smoothed_aggregation_solver(
        poisson((24, 24, 24)).astype(np.float32), max_coarse=50)
    ml.compress_stencils()
    for name in BUILT[3:]:
        attr, lvl = name.split()[1]
        op = getattr(ml.levels[int(lvl)], attr)
        assert isinstance(op, SELL), name
        out[name] = _size(op)
    classical = {
        "RS": ruge_stuben_solver(poisson((500, 500)).astype(np.float32)),
        "AIR": air_solver(advection_2d((256, 256))[0].astype(np.float32),
                          CF="PMIS", filter_operator=(False, 0.1))}
    for ml in classical.values():
        ml.compress_stencils()
    for name, plan in CLASSICAL.items():
        path, (attr, lvl) = name.split()
        op = getattr(classical[path].levels[int(lvl)], attr)
        assert (op.kind, op.t, op.n_passes, op.Sy) == plan, name
        out[name] = _size(op)
    return out


def _spmv_check(check, T, n):
    g = sk.spmv_geometry(T, n)
    assert g.slabs * LANE >= n
    if check == "coverage":
        count, _, owners = sk.spmv_schedule(g, T)
        assert (count == 1).all() and (owners == 1).all()
    elif check == "pass_order":
        assert sk.spmv_schedule(g, T)[1] == list(range(T))
    elif check == "shared_memory":
        assert 0 <= g.smem <= sk.MAX_SMEM
        assert (g.smem == 0) == (g.groups == 1 and g.cluster == 1)
        assert g.buffers == (2 if g.rounds > 1 else 1)
    elif check == "cluster":
        assert g.cluster in (1, 2, 4, 8) and g.groups in (1, 2, 4, 8)
        assert g.threads <= 1024
        if g.direct:
            assert g.blocks * g.threads >= n


def _gs_check(check, T, rows):
    g = sk.gs_geometry(T, rows)
    assert g.tiles * sk.GS_TILE == rows and g.chunk % g.groups == 0
    if check == "coverage":
        for reverse in (False, True):
            tiles, count, _ = sk.gs_schedule(g, T, reverse)
            assert sorted(tiles) == list(range(g.tiles))
            assert tiles == sorted(tiles, reverse=reverse)
            assert (count == 1).all()
    elif check == "pass_order":
        assert sk.gs_schedule(g, T)[2] == list(range(T))
    elif check == "shared_memory":
        assert 0 < g.smem + sk.K5_STATIC_SMEM <= sk.MAX_SMEM
        assert 2 <= g.stages <= 4
    elif check == "cluster":
        assert sk.GS_CLUSTER == 8 and g.groups in (1, 2, 4, 8)
    elif check == "x_regime":
        # x stays in shared memory exactly when it fits beside two stages
        # that each hold a tile's passes (up to a box of 256)
        whole = min(-(-T // g.groups) * g.groups, 256)
        fits = rows * 4 + 2 * whole * LANE * 8 + T * 4 + \
            sk.K5_STATIC_SMEM <= sk.MAX_SMEM
        assert g.x_shared == fits
        assert g.chunk == whole or not g.x_shared


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("plan", SPMV_PLANS)
def test_spmv_geometry(sizes, plan, check):
    T, n, _, _ = sizes[plan]
    _spmv_check(check, T, n)


@pytest.mark.parametrize("check", CHECKS + ["x_regime"])
@pytest.mark.parametrize("plan", GS_PLANS)
def test_gs_geometry(sizes, plan, check):
    T, _, rows, square = sizes[plan]
    assert square
    _gs_check(check, T, rows)


def test_geometry_regimes():
    """The shapes the designs are for: a wide, short operator keeps one
    thread per row; the narrow R1 and A2 (6 slabs) spread over clusters of
    8 blocks, of 8 and 4 pass-groups, the wide R0 and A1 take 4 pass-groups
    and no cluster; K5 keeps A2's x in shared memory, and A1's (where
    it would leave room for less than a tile's passes) and the 1800^2
    plan's in device memory."""
    wide = sk.spmv_geometry(5, 1800 * 1800)
    assert (wide.groups, wide.cluster, wide.rounds) == (1, 1, 1)
    assert sk.spmv_geometry(13, 262144).cluster == 1
    deep = sk.spmv_geometry(839, 768)
    assert (deep.groups, deep.cluster) == (8, 8)
    assert deep.blocks == 48
    assert (sk.spmv_geometry(89, 768).groups,
            sk.spmv_geometry(89, 768).cluster) == (4, 8)
    for T in (152, 66):
        assert (sk.spmv_geometry(T, 31868).groups,
                sk.spmv_geometry(T, 31868).cluster) == (4, 1)
    assert not sk.gs_geometry(66, 256 * LANE).x_shared
    assert sk.gs_geometry(66, 256 * LANE).chunk == 72     # one chunk a tile
    assert sk.gs_geometry(89, 8 * LANE).x_shared
    assert not sk.gs_geometry(5, 25600 * LANE).x_shared
