"""The whole measured window over the steps completed in it (ms)."""

from __future__ import annotations


def read(rec):
    if not rec.step_times:
        return None
    return rec.window_s / len(rec.step_times) * 1e3
