"""The least time of the window's SpMV calls over the device time of
what they launched (%)."""

from __future__ import annotations

from cardbench.metrics import roofline_share


def read(rec):
    return roofline_share(rec, "spmv")
