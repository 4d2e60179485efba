"""Matplotlib aggregate outlines (counterpart of ``pyamg_tpu/vis/aggviz.py``;
reference ``pyamg/vis/aggviz.py:15``)."""

from __future__ import annotations

import numpy as np


def plotaggs(AggOp, V, G, ax, aggvals=None, cmap=None, buffer=(0.1, 0.05),
             **kwargs):
    """Plot aggregates as filled blobs over the mesh (reference
    ``aggviz.py:15``).  Requires matplotlib; shapely (if present) gives
    smooth buffered outlines, else convex hulls."""
    from pyamg_tpu_torch.vis.vis_coarse import _aggop_labels
    V = np.asarray(V)
    labels = _aggop_labels(AggOp)
    nagg = labels.max() + 1
    try:
        import matplotlib.pyplot as plt  # noqa: F401
        from matplotlib.patches import Polygon
    except ImportError as e:  # pragma: no cover
        raise ImportError("plotaggs requires matplotlib") from e

    colors = None
    if aggvals is not None:
        import matplotlib.cm as cm
        cmap = cmap or cm.viridis
        vals = np.asarray(aggvals, float)
        vals = (vals - vals.min()) / max(np.ptp(vals), 1e-30)
        colors = [cmap(v) for v in vals]

    for a in range(nagg):
        pts = V[labels == a]
        if len(pts) == 0:
            continue
        color = colors[a] if colors is not None else "tab:blue"
        if len(pts) == 1:
            ax.plot(pts[0, 0], pts[0, 1], "o", color=color, **kwargs)
            continue
        if len(pts) == 2:
            ax.plot(pts[:, 0], pts[:, 1], "-", lw=3, color=color, **kwargs)
            continue
        try:
            from shapely.geometry import MultiPoint
            hull = MultiPoint([tuple(p) for p in pts]).convex_hull
            hull = hull.buffer(buffer[0]).buffer(-buffer[1])
            xy = np.asarray(hull.exterior.coords)
        except Exception:
            from scipy.spatial import ConvexHull
            try:
                h = ConvexHull(pts)
                xy = pts[h.vertices]
            except Exception:
                xy = pts
        ax.add_patch(Polygon(xy, closed=True, alpha=0.4, color=color,
                             **kwargs))
    return ax
