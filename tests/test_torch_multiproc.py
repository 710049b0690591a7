"""The process form of the mesh on a real 2-process gloo cluster, as
``tests/test_multihost.py`` does for JAX: two OS processes join one
process group through ``init_distributed``, run the ring SpMV (each rank
checks its own row shard) and the transpose SpMV (a real ``all_reduce``
and ``reduce_scatter``), the halo SpMV (a real ``all_gather``) and the
portable forms."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import numpy as np
import scipy.sparse as sps
import torch
import torch.distributed as tdist

from csr_tpu_torch import CSR
from csr_tpu_torch.parallel import (dist, init_distributed, is_initialized,
                                    mb_dist, mb_ring, ring, shutdown_distributed)
from csr_tpu_torch.parallel.partition import make_mesh, partition_rows

rank = int(sys.argv[2])
# a CPU mesh names its backend: the default follows the default device
assert init_distributed(sys.argv[1], 2, rank, backend="gloo", timeout=120), "skipped"
assert is_initialized() and not init_distributed(sys.argv[1], 2, rank)
assert tdist.get_backend() == "gloo" and tdist.get_world_size() == 2
mesh = make_mesh(2, device="cpu", group=tdist.group.WORLD)
assert (mesh.n_local, mesh.first) == (1, rank)
assert mesh.held.tolist() == [[rank], [1 - rank]]

rng = np.random.default_rng(42)  # same seed in both processes
m = sps.random(300, 520, 0.05, format="csr", random_state=rng, dtype=np.float32)
csr = CSR.from_scipy(m, device="cpu")
x = np.linspace(-1.0, 1.0, 520).astype(np.float32)
ref = m @ x
ref_t = m.T @ ref

def mine(part, y):
    # this rank's rows of the result against the host product
    assert y.shape[0] == 1, y.shape
    n, off = int(part.nrows_local[rank]), int(part.row_offset[rank])
    np.testing.assert_allclose(y[0, :n].numpy(), ref[off : off + n],
                               rtol=1e-4, atol=1e-3)

rmb = mb_ring.partition_ring_mb(csr, 2).shard(mesh)
assert rmb.vals.shape[0] == 1
mine(rmb, mb_ring.spmv_ring_mb(rmb, mb_ring.scatter_x(rmb, x, mesh), mesh))

r = ring.partition_ring(csr, 2).shard(mesh)
mine(r, ring.spmv_ring(r, ring.scatter_x(r, x, mesh), mesh))

dmb = mb_dist.partition_microblocks(csr, 2).shard(mesh)
y = mb_dist.spmv(dmb, x, mesh)
mine(dmb, y)
mine(dmb, mb_dist.spmv_halo(dmb, mb_dist.scatter_x(dmb, x, mesh), mesh))

dmbt = mb_dist.partition_microblocks_t(csr, 2).shard(mesh)
xt = mb_dist.spmv_t(dmbt, y, mesh)  # a real cross-process all_reduce
np.testing.assert_allclose(xt.numpy(), ref_t, rtol=1e-4, atol=1e-3)
xs = mb_dist.spmv_t(dmbt, y, mesh, scatter=True)  # a real reduce_scatter
n = xs.shape[1]
assert xs.shape[0] == 1 and 2 * n >= 520
want = np.zeros(2 * n, np.float32)
want[:520] = ref_t
np.testing.assert_allclose(xs[0].numpy(), want[rank * n : (rank + 1) * n],
                           rtol=1e-4, atol=1e-3)

d = partition_rows(csr, 2).shard(mesh)
yd = dist.spmv(d, x, mesh)
mine(d, yd)
mine(d, dist.spmv_halo(d, torch.from_numpy(x[rank * 260 : (rank + 1) * 260]), mesh))
np.testing.assert_allclose(dist.spmv_t(d, yd, mesh).numpy(), ref_t,
                           rtol=1e-4, atol=1e-3)

shutdown_distributed()
assert not is_initialized()
print(f"proc {rank} OK")
"""


@pytest.mark.skipif(
    os.environ.get("CSR_TPU_NO_SUBPROC") == "1",
    reason="subprocess tests disabled",
)
def test_two_process_gloo_cluster(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    script = tmp_path / "worker.py"
    script.write_text(_WORKER)

    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(name, None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(i)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out}"
        assert f"proc {i} OK" in out, out


def test_init_distributed_skips_without_coordinator(monkeypatch):
    from csr_tpu_torch import parallel

    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert parallel.init_distributed() is False
    assert not parallel.is_initialized()
    parallel.shutdown_distributed()  # nothing to leave: does nothing
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="coordinator"):
        parallel.init_distributed()


@pytest.mark.parametrize("device, nccl, want", [
    ("cpu", False, "gloo"), ("cpu", True, "gloo"),
    ("cuda", True, "nccl"), ("cuda", False, None),
])
def test_init_distributed_backend_follows_default_device(
        monkeypatch, device, nccl, want):
    """With no backend named: gloo on a CPU default device, nccl on a
    card, and an error, not a silent gloo, on a card without NCCL."""
    import torch
    import torch.distributed as tdist

    from csr_tpu_torch import kernels, parallel

    seen = []
    monkeypatch.setattr(kernels, "default_device", lambda: torch.device(device))
    monkeypatch.setattr(tdist, "is_nccl_available", lambda: nccl)
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda backend, **kw: seen.append(backend))
    monkeypatch.setattr(tdist, "get_rank", lambda: 0)
    monkeypatch.setattr(tdist, "get_world_size", lambda: 1)
    monkeypatch.setattr(parallel, "_initialized", False)
    if want is None:
        with pytest.raises(RuntimeError, match="NCCL"):
            parallel.init_distributed("localhost:1", 1, 0)
        assert not seen and not parallel.is_initialized()
        assert parallel.init_distributed("localhost:1", 1, 0, backend="gloo")
        assert seen == ["gloo"]
    else:
        assert parallel.init_distributed("localhost:1", 1, 0)
        assert seen == [want]
