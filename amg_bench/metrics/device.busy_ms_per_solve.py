"""Milliseconds the device is busy in one solve: the union of the device
operations of b_0's solve profiled in the per-step form, over the
profiled calls.  The device's share of ``solve_ms``, without the host's
jitter that widens that metric's spread."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    return prof["busy_s"] / prof["calls"] * 1e3
