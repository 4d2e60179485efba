"""A hand kernel's share of its roofline over the traced solves."""


def share(rec, kernel, names, bytes_of, bound_of):
    """100 x (sum of the bounds of ``kernel``'s launches) / (sum of their
    device time), the launches per operator from the program's counters
    (``rec["kernels"][kernel]``: ``by_op`` {(rows, diagonals): launches},
    ``itemsize``), the device time from the trace's operations whose names
    hold one of ``names``.  None where the kernel did not run, or where the
    trace holds another number of its launches than the counters (a share
    of part of the time would be too high)."""
    k = rec.get("kernels", {}).get(kernel)
    prof = rec.get("profile")
    if not k or not prof:
        return None
    launches = sum(k["by_op"].values())
    times = [e - s for name, s, e in prof["device_ops"]
             if any(n in name for n in names)]
    if not launches or len(times) != launches or sum(times) <= 0:
        return None
    bound = sum(c * bound_of(bytes_of(n, nd, k["itemsize"]))
                for (n, nd), c in k["by_op"].items())
    return 100.0 * bound / (sum(times) / 1e6)
