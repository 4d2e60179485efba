"""Seconds of the distributed set-up on the card: ``dist_stencil_grid``
and ``distributed_sa_setup``, host clock ending in a synchronize."""


def read(rec):
    return rec["setup"].get("dist")
