"""Host seconds of each matrix's first product call in set-up, summed:
packing, the route statistic, cached edges and transposes (s)."""

from __future__ import annotations


def read(rec):
    if not rec.first_calls:
        return None
    return sum(rec.first_calls.values())
