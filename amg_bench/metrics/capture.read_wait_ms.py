"""Milliseconds of a solve's one read of its loop's results, in the form
the window runs (span ``graph.read`` of form ``device``: after a device
loop's launch on the card, the wait for the device; op by op on the
CPU); the per-step form's reads are left out."""

from amg_bench.harness.program_store import total


def read(rec):
    t = total("graph.read[device]")
    return t and t[1] / t[0] / 1e6
