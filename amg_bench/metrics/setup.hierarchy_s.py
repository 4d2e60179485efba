"""Seconds of the host set-up: the factory call that builds the
hierarchy (``smoothed_aggregation_solver``), host clock."""


def read(rec):
    return rec["setup"].get("hierarchy")
