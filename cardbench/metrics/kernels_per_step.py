"""Device kernels in the profiled window over its steps."""

from __future__ import annotations


def read(rec):
    p = rec.profile
    if not p or not p["steps"]:
        return None
    return sum(n for kind, n, _ in p["device"].values() if kind == "kernel") / p["steps"]
