"""
One reader a metric: ``metrics/<name>.py`` defines ``read(rec)``, which
takes the run's :class:`cardbench.cell.Record` and gives the metric's
value, or None where the run holds nothing to read (the harness then
leaves the metric out of the line).  :func:`reader` finds a metric by
the name ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import importlib


def reader(name: str):
    return importlib.import_module(f"{__name__}.{name}").read


def roofline_share(rec, kind: str):
    """The least time of the profiled window's ``kind`` product calls
    over the device time of what they launched (%), or None."""
    p = rec.profile
    k = p and p["products"].get(kind)
    if not k or not k["device_ns"]:
        return None
    return 100.0 * k["least_ms"] / (k["device_ns"] / 1e6)
