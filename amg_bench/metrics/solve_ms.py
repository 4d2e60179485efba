"""Milliseconds a solve: the measured window's wall time over the
right-hand sides solved in it, from the call with b to x returned."""


def read(rec):
    win = rec.get("window")
    return win["wall_s"] / len(win["walls"]) * 1e3 if win else None
