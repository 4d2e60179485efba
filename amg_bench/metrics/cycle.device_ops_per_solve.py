"""Device operations of one solve, counted in the trace of the solves
profiled in the per-step form (one CUDA graph a step)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["device_ops"]:
        return None
    return len(prof["device_ops"]) / prof["calls"]
