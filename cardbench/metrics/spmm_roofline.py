"""The least time of the window's SpMM calls (``roofline.least_ms`` of
the bytes and operations they need) over the device time of the kernels,
copies and fills those calls launched (%)."""

from __future__ import annotations

from cardbench.metrics import roofline_share


def read(rec):
    return roofline_share(rec, "spmm")
