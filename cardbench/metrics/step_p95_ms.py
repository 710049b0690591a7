"""The 95th percentile of every step's wall time in the window, from its
start to its synchronise (ms), by ``statistics.quantiles``."""

from __future__ import annotations

import statistics


def read(rec):
    if len(rec.step_times) < 2:
        return None
    return statistics.quantiles(rec.step_times, n=20)[18] * 1e3
