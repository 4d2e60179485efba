"""The 95th percentile, by the nearest rank, of every solve's wall time
in the measured window, in milliseconds."""

import math


def read(rec):
    win = rec.get("window")
    if not win:
        return None
    ordered = sorted(win["walls"])
    return ordered[max(int(math.ceil(0.95 * len(ordered))) - 1, 0)] * 1e3
