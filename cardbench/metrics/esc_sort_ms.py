"""Device time a step of the sort kernels (names holding ``sort`` or
``Sort``) in the profiled window (ms)."""

from __future__ import annotations


def read(rec):
    p = rec.profile
    if not p or not p["steps"]:
        return None
    ns = sum(t for name, (kind, _, t) in p["device"].items()
             if kind == "kernel" and ("sort" in name or "Sort" in name))
    if not ns:
        return None
    return ns / p["steps"] / 1e6
