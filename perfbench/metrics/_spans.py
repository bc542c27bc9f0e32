"""What the readers of the program's own spans and counters share: the
window's records from ``gpras_tpu_torch.utils.profiling``, which record
only while a profiler does, so in a ``--trace 1`` run they are the traced
window's. A program without spans gives None, and so does each reader."""

from __future__ import annotations


def program() -> tuple[list[dict], dict[str, int]] | None:
    """(spans, counter totals) the program recorded, or None where it
    records none."""
    try:
        from gpras_tpu_torch.utils import profiling
    except ImportError:
        return None
    records = getattr(profiling, "records", None)
    totals = getattr(profiling, "totals", None)
    if records is None or totals is None:
        return None
    return records(), totals()


def named(spans: list[dict], name: str) -> list[dict]:
    return [s for s in spans if s["name"] == name]


def host_ms_per(name: str, per: str) -> float | None:
    """Host milliseconds of the spans ``name``, summed, over the number of
    spans ``per``: the mean time of a stage per request."""
    got = program()
    if got is None:
        return None
    stage, n = named(got[0], name), len(named(got[0], per))
    if not stage or not n:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in stage) * 1e-6 / n
