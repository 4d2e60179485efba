"""Mean inner Krylov iterations a solve over the measured window, as the
program reports them (``iterations_out`` or the returned count)."""


def read(rec):
    inner = rec.get("inner")
    return sum(inner) / len(inner) if inner else None
