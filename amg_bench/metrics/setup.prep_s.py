"""Seconds of the prep: ``compress_stencils``, ``collapse_coarse``,
``enable_ds_refinement`` and ``to_device``, host clock ending in a
synchronize."""


def read(rec):
    return rec["setup"].get("prep")
