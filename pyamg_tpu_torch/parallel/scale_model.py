"""Memory model of the distributed SA hierarchy (counterpart of
``pyamg_tpu/parallel/scale_model.py``).

It replays the static shape laws of the port's ``distributed_sa_setup``
(``parallel/dist_setup.py``: the width caps of each level, ``c_cap``
coarse rows a rank, the ghost margins and the transfer margin), so that
the bytes a rank holds can be computed for any (n, W, ndev) without
building anything.  The port stores a level as the JAX package does (int32
columns, float32 values, a bool mask), so the two models agree;
``tests/test_torch_dist_setup.py`` holds this one against the arrays of a
built hierarchy.  Plain Python: no tensor is made.
"""

from __future__ import annotations

import dataclasses
from typing import List

# bytes per stored ELL slot: int32 col + f32 val + bool ok
_SLOT = 4 + 4 + 1
_PROP_ROUNDS = 3           # dist_setup._PROP_ROUNDS


def _caps(W_in, wp_cap=12, wr_cap=48, wac_cap=24):
    """The width caps of a level (``dist_setup._level_step``)."""
    wp = max(wp_cap, W_in + 1)
    wr = max(wr_cap, 2 * wp)
    wac = max(wac_cap, W_in + 8)
    return wp, wr, wac


@dataclasses.dataclass
class LevelModel:
    n_loc: int          # rows per device (padded)
    W: int              # operator width
    wp: int             # P width
    wr: int             # R width
    c_cap: int          # coarse rows per device
    g: int              # operator ghost margin (rows)
    gP: int             # transfer ghost margin

    def operator_bytes(self):
        """Steady-state per-device storage of this level."""
        A = self.n_loc * self.W * _SLOT
        Dinv = self.n_loc * 4
        P = self.n_loc * self.wp * _SLOT
        R = self.c_cap * self.wr * _SLOT
        return A + Dinv + P + R

    def setup_peak_bytes(self):
        """Transient peak during _level_step: the gP-extended P / AP
        arrays dominate (everything else is O(n_loc * W))."""
        ext = self.n_loc + 2 * self.gP
        wac = _caps(self.W)[2]
        p_ext = 3 * ext * self.wp * _SLOT        # cols/vals/ok extensions
        ap = self.n_loc * wac * _SLOT
        ap_ext = 3 * ext * wac * _SLOT
        return self.operator_bytes() + p_ext + ap + ap_ext

    def solve_vectors_bytes(self, n_vectors=8):
        """x, r, z, p + cycle temporaries, f32."""
        return n_vectors * self.n_loc * 4


def model_hierarchy(n, W, ndev, levels=5, coarse_ratio=4,
                    margin_fracs=(0.01, 0.65, 1.0, 1.0, 3.0),
                    bandwidth=None) -> List[LevelModel]:
    """Shape model of a distributed SA hierarchy.

    ``margin_fracs``: ghost margin as a fraction of the level's n_loc
    (fine level uses the grid bandwidth instead; coarse-level fractions
    are taken from the measured 2M artifact ``benchmarks/DIST_SCALE.json``
    margins/n_loc = [~0.006, 0.62, 0.91, 1.0, 3.0] — rounded up)."""
    n_loc = -(-n // ndev)
    if bandwidth is None:
        bandwidth = int(round(n ** 0.5))      # 2D grid row-ordering
    out = []
    Wl = W
    for lvl in range(levels):
        c_cap = max(n_loc // coarse_ratio, 1)
        wp, wr, wac = _caps(Wl)
        g = bandwidth if lvl == 0 else \
            int(margin_fracs[min(lvl, len(margin_fracs) - 1)] * n_loc)
        gP = min((_PROP_ROUNDS + 1) * g, ndev * n_loc)
        out.append(LevelModel(n_loc=n_loc, W=Wl, wp=wp, wr=wr,
                              c_cap=c_cap, g=g, gP=gP))
        n_loc = c_cap
        Wl = wac
    return out


def summarize(n, W, ndev, levels=5, hbm_bytes=80e9, **kw):
    """A rank's totals and whether they fit in ``hbm_bytes`` (default the
    80 GB of an H100), for one mesh size."""
    levs = model_hierarchy(n, W, ndev, levels=levels, **kw)
    steady = sum(l.operator_bytes() for l in levs)
    vectors = sum(l.solve_vectors_bytes() for l in levs)
    peak_setup = max(
        sum(l.operator_bytes() for l in levs[:i]) + levs[i].setup_peak_bytes()
        for i in range(len(levs)))
    total_solve = steady + vectors
    total_setup = peak_setup + vectors
    return {
        "ndev": ndev,
        "n_loc_fine": levs[0].n_loc,
        "per_level": [dataclasses.asdict(l) for l in levs],
        "steady_state_gb": round(steady / 1e9, 3),
        "solve_vectors_gb": round(vectors / 1e9, 3),
        "setup_peak_gb": round(peak_setup / 1e9, 3),
        "total_solve_gb": round(total_solve / 1e9, 3),
        "total_setup_gb": round(total_setup / 1e9, 3),
        "hbm_gb": hbm_bytes / 1e9,
        "fits_solve": total_solve < hbm_bytes,
        "fits_setup": total_setup < hbm_bytes,
    }
