"""
Debug guards (counterpart of :mod:`csr_tpu.utils.debug`).

* :func:`guard_transfers` makes a hidden host-device synchronisation
  inside a block raise (or warn): the analog of JAX's transfer guard, on
  ``torch.cuda.set_sync_debug_mode``.  A read of a card's tensor on the
  host (``int(t)``, ``t.item()``, ``t.cpu()`` of a result) waits for the
  card and stalls the stream of launches behind it.
* :func:`check_handle_leaks` asserts that every ``to_handle`` in a block
  is balanced by a ``release_handle``, from the kernels' trace events.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def guard_transfers(level: str = "error"):
    """Raise (``"error"``) or warn (``"warn"``) on every CUDA operation
    inside the block that synchronises the host with the card; the
    previous mode is restored on exit.  Needs a CUDA device.

    Example::

        with guard_transfers():
            y = a.mult_vec(x)      # a hidden host read raises
    """
    if not torch.cuda.is_available():
        raise RuntimeError("guard_transfers watches CUDA synchronisations;"
                           " there is no CUDA device")
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(level)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


class HandleCounter:
    """Counts ``to_handle`` and ``release_handle`` trace events."""

    def __init__(self):
        self.created = 0
        self.released = 0

    @property
    def outstanding(self) -> int:
        return self.created - self.released

    def __call__(self, event, fields):
        if event == "to_handle":
            self.created += 1
        elif event == "release_handle":
            self.released += 1


@contextmanager
def check_handle_leaks(strict: bool = True):
    """Yield a :class:`HandleCounter` over the block; with ``strict``,
    raise AssertionError on exit if a handle made in the block was not
    released.  An exception from the block passes through unchanged.

    Example::

        with check_handle_leaks():
            with releasing(K.to_handle(a), K) as h:
                y = K.mult_vec(h, x)
    """
    from csr_tpu_torch import kernels

    counter = HandleCounter()
    kernels._listeners.append(counter)
    try:
        yield counter
    finally:
        kernels._listeners.remove(counter)
    if strict and counter.outstanding:
        raise AssertionError(f"handle leak: {counter.created} to_handle vs "
                             f"{counter.released} release_handle in the block")
