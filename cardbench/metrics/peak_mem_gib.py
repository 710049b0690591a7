"""``torch.cuda.max_memory_allocated()`` from the hand-over of the
generated triples (the generator's own temporaries freed and the peak
reset) to the close of the window, the program's set-up included (GiB)."""

from __future__ import annotations


def read(rec):
    return rec.peak_bytes / 2**30
