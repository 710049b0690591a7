"""Host time from entering to leaving each public SpMM or SpMV call
(``mult_dense``, ``mult_vec``, ``mult_vec_t``), no synchronise inside,
over the traced run's first phase, divided by the calls (ms)."""

from __future__ import annotations


def read(rec):
    calls = rec.api_host.get("spmm", []) + rec.api_host.get("spmv", [])
    if not calls:
        return None
    return sum(calls) / len(calls) * 1e3
