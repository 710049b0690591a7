"""Process start to the first measured step: data, set-up, first products,
warm-up (s)."""

from __future__ import annotations


def read(rec):
    return rec.setup_s
