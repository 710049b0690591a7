"""Share of the profiled window in which nothing ran on the card (%)."""

from __future__ import annotations


def read(rec):
    p = rec.profile
    if not p or not p["window_ns"]:
        return None
    return 100.0 * (1.0 - p["busy_ns"] / p["window_ns"])
