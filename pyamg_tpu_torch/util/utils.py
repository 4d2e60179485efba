"""Option helpers (counterpart of ``pyamg_tpu/util/utils.py:levelize``)."""

from __future__ import annotations


def levelize(spec, max_levels):
    """Per-level option list: a single spec broadcasts; a list extends
    with its last element (reference ``levelize_strength_or_aggregation``
    and ``levelize_smooth_or_improve_candidates``)."""
    if isinstance(spec, list) or (
            isinstance(spec, tuple) and len(spec) and
            (isinstance(spec[0], (tuple, list)) or spec[0] is None or
             (isinstance(spec[0], str) and not (
                 len(spec) == 2 and isinstance(spec[1], dict))))):
        items = list(spec)
    else:
        items = [spec]
    k = max(max_levels - 1, 1)
    items = items + [items[-1]] * k
    return items[:k]
