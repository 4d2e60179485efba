"""The device's idle share of the timed solve, in percent: 1 - busy /
wall for one right-hand side.  Busy is the union of the device operations
of its solve profiled in the per-step form (the same operations, bit for
bit, as the device-stopped solve, whose conditional bodies the profiler
may miss); wall is the median of the same solve device-stopped, timed
before any profiler run of the process.

The result line's ``busy_s`` / ``window_s`` come from one form alone, the
profiled per-step window, and read higher idle: that form launches one
graph a step from the host, and the gaps between those launches are no
part of the device-stopped solve.  The profiler's tracing lengthens
kernels a little, so a card that is never idle in the device-stopped
solve can read a little below 0 here."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0:
        return None
    busy = prof["busy_s"] / prof["calls"]
    return 100.0 * (1.0 - busy / prof["device_stopped_s"])
