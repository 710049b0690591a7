"""
Distributed layer (counterpart of :mod:`csr_tpu.parallel`): partitioning
over a mesh of shards, the distributed ops, and the process-level entry
point for running a mesh across processes.

Modules:

* :mod:`~csr_tpu_torch.parallel.partition` -- nnz-balanced row
  partitioning, and the :class:`~csr_tpu_torch.parallel.partition.Mesh`
  with its collectives (one process holding all shards on one device, or
  one ``torch.distributed`` rank per shard).
* :mod:`~csr_tpu_torch.parallel.dist`      -- portable plain-PyTorch ops.
* :mod:`~csr_tpu_torch.parallel.mb_dist`   -- the ops on the micro-block
  SpMV kernel.
* :mod:`~csr_tpu_torch.parallel.ring`      -- the ring schedule, portable.
* :mod:`~csr_tpu_torch.parallel.mb_ring`   -- the ring schedule on the
  bucket-selecting micro-block kernel.
"""

from __future__ import annotations

import datetime
import logging
import os

_log = logging.getLogger(__name__)
_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout: float = 600.0,
):
    """Join this process to a ``torch.distributed`` process group.

    Wraps ``torch.distributed.init_process_group`` with a
    ``tcp://address:port`` rendezvous.  Arguments left out are read from
    the standard environment variables ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``.  ``backend`` follows the default device,
    since the group is made before any mesh: ``nccl`` where that is a card
    (raising if this PyTorch has no NCCL), else ``gloo``.  A mesh on
    another device than the default one must name its backend: a CPU mesh
    on a machine with a card passes ``backend="gloo"``.  ``timeout``
    (seconds) bounds every collective, so a dead peer raises instead of
    hanging.

    Safe to call more than once (later calls do nothing) and safe in a
    single-process run with no coordinator configured (returns False).

    Returns:
        bool: True if the process group was initialized, False if skipped.
    """
    global _initialized
    if _initialized:
        return False

    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr and port:
            coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        env = os.environ.get("WORLD_SIZE")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("RANK")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        _log.debug("init_distributed: no coordinator configured; skipping")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs a coordinator address, the number of "
            "processes and this process's id (arguments, or MASTER_ADDR, "
            "MASTER_PORT, WORLD_SIZE and RANK)")

    import torch.distributed as dist

    from csr_tpu_torch.kernels import default_device

    if backend is None:
        on_card = default_device().type == "cuda"
        if on_card and not dist.is_nccl_available():
            raise RuntimeError(
                "init_distributed: the default device is a card but this "
                "PyTorch has no NCCL; pass backend='gloo' to stage every "
                "collective through the host")
        backend = "nccl" if on_card else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    _initialized = True
    _log.info("init_distributed: process %d/%d on %s", dist.get_rank(),
              dist.get_world_size(), backend)
    return True


def is_initialized() -> bool:
    """Whether :func:`init_distributed` has run in this process."""
    return _initialized


def shutdown_distributed():
    """Leave the process group (test-cluster hygiene).  Every rank waits
    at a barrier first: rank 0 hosts the group's ``TCPStore``, and a rank
    that left while another still used the store could abort the other in
    its teardown."""
    global _initialized
    if _initialized:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
        _initialized = False
