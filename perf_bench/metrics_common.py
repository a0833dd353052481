"""Shared by the per-layer metric readers: the traced record of a kind."""


def traced(rec: dict, kind: str):
    """The traced sub-window's record when `rec` is a run of `kind`, else None."""
    if rec.get("kind") != kind:
        return None
    return rec.get("trace")
