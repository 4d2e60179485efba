"""C/F splittings for classical AMG (counterpart of
``pyamg_tpu/classical/split.py``; setup phase).

PMIS, PMISc, CLJP, CLJPc and MIS are Luby-style fixed-point rounds over the
ELL strength pattern, iterated on the host with numpy: a node wins a round
when its key is strictly greater than every undecided neighbour's in
S + S^T.  RS is the sequential greedy splitting, in the native host core
(``_native/classical.cpp``); without a compiler it raises.

Convention (the reference's): ``S[i, j] != 0`` means node i strongly
depends on node j.  Each splitting is an int32 array, 1 = C, 0 = F.
"""

from __future__ import annotations

import numpy as np

from pyamg_tpu_torch.sparse.matrix import ELL, to_scipy


def _pattern_no_diag(S: ELL):
    """(cols, mask) of S with the diagonal, the padding and stored zeros
    masked out."""
    cols = np.asarray(S.cols)
    rows = np.arange(S.shape[0], dtype=np.int32)[:, None]
    return cols, S.valid_mask() & (cols != rows) & (np.asarray(S.vals) != 0)


def _col_degree(cols, mask, n):
    """In-degree over the strength graph: how many nodes each node
    influences."""
    return np.bincount(cols[mask], minlength=n).astype(np.int32)


def _ones(S: ELL, mask):
    """S's stored pattern with 1 on the strong off-diagonal slots."""
    return ELL(S.cols, np.where(mask, 1.0, 0.0), S.row_nnz, S.shape)


def _symmetrized(S: ELL):
    """(cols, mask, tcols, tmask): the strong pattern of S and of S^T, the
    out- and in-edges of G = S + S^T."""
    from pyamg_tpu_torch.ops.transpose import transpose
    cols, mask = _pattern_no_diag(S)
    tcols, tmask = _pattern_no_diag(transpose(_ones(S, mask)))
    return cols, mask, tcols, tmask


def _neighbour_max(cols, mask, tcols, tmask, live, keys):
    """Largest key of the live neighbours of each node in S + S^T (-inf
    where there is none)."""
    nk1 = np.where(live[cols] & mask, keys[cols], -np.inf)
    nk2 = np.where(live[tcols] & tmask, keys[tcols], -np.inf)
    return np.maximum(nk1.max(axis=1, initial=-np.inf),
                      nk2.max(axis=1, initial=-np.inf))


def _mis_round2(cols, mask, tcols, tmask, state, keys):
    """One Luby round over S + S^T.  state: 0 active, 1 in the set (C),
    -1 removed (F)."""
    active = state == 0
    winner = active & (keys > _neighbour_max(cols, mask, tcols, tmask,
                                             active, keys))
    nwin = (winner[cols] & mask).any(axis=1) | \
        (winner[tcols] & tmask).any(axis=1)
    state = np.where(winner, 1, state)
    return np.where((state == 0) & nwin, -1, state).astype(np.int8)


def _weights(S: ELL, coloring_method=None, seed=0):
    """PMIS/CLJP keys: in-degree plus a uniform draw from ``seed``, with the
    draw shifted by a vertex coloring of S + S^T and scaled by the number
    of colors when ``coloring_method`` is given (reference
    ``split.py:388-448``)."""
    n = S.shape[0]
    cols, mask = _pattern_no_diag(S)
    deg = _col_degree(cols, mask, n).astype(np.float64)
    r = np.random.default_rng(seed).random(n)
    if coloring_method is None:
        return deg + r
    from pyamg_tpu_torch.graph import vertex_coloring
    from pyamg_tpu_torch.ops.arith import add
    from pyamg_tpu_torch.ops.transpose import transpose
    ones = _ones(S, mask)
    coloring = vertex_coloring(add(ones, transpose(ones)),
                               method=coloring_method, seed=seed)
    ncolors = int(coloring.max()) + 1
    return deg + (r + coloring) / ncolors


def _mis_split(S: ELL, keys, max_iters=None):
    """Luby MIS over S + S^T; its members are the C points.  Nodes with no
    strong connection either way (Dirichlet rows) are F."""
    n = S.shape[0]
    cols, mask, tcols, tmask = _symmetrized(S)
    state = np.zeros((n,), np.int8)
    it = 0
    while (state == 0).any():
        state = _mis_round2(cols, mask, tcols, tmask, state, keys)
        it += 1
        if max_iters is not None and it >= max_iters:
            break
        if it > n + 2:
            raise RuntimeError("MIS splitting failed to converge")
    splitting = (state == 1).astype(np.int32)
    splitting[~(mask.any(axis=1) | tmask.any(axis=1))] = 0
    return splitting


def MIS(G: ELL, weights, maxiter=None):
    """Maximal independent set of G under the given vertex weights
    (reference ``split.py:155`` helper / ``graph.h:140``)."""
    return _mis_split(G, np.asarray(weights, np.float64), max_iters=maxiter)


def PMIS(S: ELL, seed=0):
    """Parallel modified independent set splitting (reference
    ``split.py:155``): Luby MIS with in-degree + random keys."""
    return _mis_split(S, _weights(S, None, seed))


def PMISc(S: ELL, method="JP", seed=0):
    """PMIS in color (reference ``split.py:197``): keys shifted by a
    vertex coloring."""
    return _mis_split(S, _weights(S, method, seed))


def _cljp_update(cols, mask, edgemark, w, state, D):
    """The weight updates of one CLJP pass (reference
    ``ruge_stuben.h:683-746``); state: 0 undecided, 1 C, -1 F; edgemark:
    the live strong slots of S.

    P5: for each new C point c, the live edges of row c to undecided j are
    removed and w_j decremented.  P6: the live edge (j <- k), k undecided,
    is removed and w_k decremented when j and k both depend on a common
    new C point (once, however many such points there are)."""
    n = state.shape[0]
    state = np.where(D, 1, state)
    undecided = state == 0

    rem5 = D[:, None] & mask & edgemark & undecided[cols]
    dec5 = np.zeros((n,), w.dtype)
    np.add.at(dec5, cols[rem5], 1.0)
    edgemark = edgemark & ~rem5

    dep_slot = mask & D[cols]            # slots of row j on a new C point
    kcols = cols[cols]                   # (n, W, W): rows of the neighbours
    kmask = mask[cols]
    eq = kcols[:, :, :, None] == cols[:, None, None, :]
    common = (eq & kmask[:, :, :, None] &
              dep_slot[:, None, None, :]).any(axis=(2, 3))
    rem6 = mask & edgemark & undecided[cols] & \
        dep_slot.any(axis=1)[:, None] & common
    dec6 = np.zeros((n,), w.dtype)
    np.add.at(dec6, cols[rem6], 1.0)
    edgemark = edgemark & ~rem6

    w = w - dec5 - dec6
    state = np.where((state == 0) & (w < 1), -1, state)
    return edgemark, w, state


def CLJP(S: ELL, color=False, seed=0):
    """Cleary-Luby-Jones-Plassmann splitting (reference ``split.py:243`` /
    ``ruge_stuben.h:578``), in data-parallel rounds: each round the
    undecided nodes whose weight beats every undecided neighbour's in
    S + S^T become C, then the weights fall by the P5/P6 rules and nodes
    under 1 become F."""
    n = S.shape[0]
    w = _weights(S, "MIS" if color else None, seed)
    cols, mask, tcols, tmask = _symmetrized(S)
    state = np.zeros((n,), np.int8)
    edgemark = mask
    it = 0
    while (state == 0).any():
        undecided = state == 0
        D = undecided & (w > _neighbour_max(cols, mask, tcols, tmask,
                                            undecided, w))
        if not D.any():
            # an isolated remainder: no node can win (all ties at -inf)
            state = np.where(state == 0, -1, state)
            break
        edgemark, w, state = _cljp_update(cols, mask, edgemark, w, state, D)
        it += 1
        if it > n + 2:
            raise RuntimeError("CLJP failed to converge")
    return (state == 1).astype(np.int32)


def CLJPc(S: ELL, seed=0):
    """CLJP in color (reference ``split.py:297``)."""
    return CLJP(S, color=True, seed=seed)


def RS(S: ELL, second_pass=False):
    """Ruge-Stuben splitting (reference ``split.py:99`` /
    ``ruge_stuben.h:285``): the sequential greedy first pass, and with
    ``second_pass`` the repair of strong F-F pairs without a common C
    point, in the native host core."""
    from pyamg_tpu_torch import _native
    A = to_scipy(S).tocsr()
    A.setdiag(0)
    A.eliminate_zeros()
    A.sort_indices()
    T = A.T.tocsr()
    T.sort_indices()
    return _native.rs_cf_splitting(A.shape[0], A.indptr, A.indices,
                                   T.indptr, T.indices,
                                   second_pass=second_pass)


def _mis_name(S, seed=0, **opts):
    return _mis_split(S, _weights(S, None, seed))


SPLITTINGS = {"RS": RS, "PMIS": PMIS, "PMISc": PMISc, "CLJP": CLJP,
              "CLJPc": CLJPc, "MIS": _mis_name}


def split_dispatch(S: ELL, spec, seed=0):
    """PyAMG's ``(name, {opts})`` C/F convention (or a callable);
    ``seed`` reaches PMIS, PMISc, CLJP and CLJPc unless the options set
    one."""
    from pyamg_tpu_torch.relaxation.smoothing import unpack_arg
    name, opts = unpack_arg(spec)
    if callable(name):
        return np.asarray(name(S, **opts), np.int32)
    name = str(name)
    if name not in SPLITTINGS:
        raise ValueError(f"unknown C/F splitting method {name!r}")
    if name in ("PMIS", "PMISc", "CLJP", "CLJPc"):
        opts.setdefault("seed", seed)
    return np.asarray(SPLITTINGS[name](S, **opts), np.int32)
