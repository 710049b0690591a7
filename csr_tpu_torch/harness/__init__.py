"""
The port's benchmark harness: the counterparts of the JAX package's root
scripts ``bench.py``, ``benchmarks.py``, ``bench_weak.py`` and
``timings_report.py``, which stay as they are and remain the TPU's.

Each module runs as ``python -m csr_tpu_torch.harness.<name>``:

* :mod:`~csr_tpu_torch.harness.bench` -- the flagship SpMV metric, one
  JSON line;
* :mod:`~csr_tpu_torch.harness.benchmarks` -- the reference's six
  benchmark groups across the ``scipy``, ``torch`` and ``cuda`` backends,
  runs saved under ``bench_history_torch/`` with ``--save``;
* :mod:`~csr_tpu_torch.harness.bench_weak` -- weak scaling of the
  distributed SpMV (``mb_dist`` halo, ``mb_ring``);
* :mod:`~csr_tpu_torch.harness.timings_report` -- a summary of saved runs
  and a comparison between two of them.

On the card every time comes from CUDA events after a synchronise.  On
the CPU the modules run at a shrunken size on the kernels' plain versions
and time with the host's clock: that checks the plumbing, and none of its
numbers is a device measurement.
"""

from __future__ import annotations

import os
import subprocess

import torch

#: the repository's root
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: where ``benchmarks --save`` writes its runs (never the TPU's
#: ``bench_history/``)
HISTORY_DIR = os.path.join(ROOT, "bench_history_torch")


def on_card() -> bool:
    """Whether the harness runs on a CUDA card (else on the CPU)."""
    return torch.cuda.is_available()


def device_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, or ``cpu``."""
    if not on_card():
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    """Wait for the card (nothing on the CPU)."""
    if on_card():
        torch.cuda.synchronize()


def tols(*dtypes):
    """Comparison tolerances by value dtype: a copy of the JAX suite's
    ``tests/util.py:tols`` (f32: rtol 5e-4, atol 5e-3)."""
    import numpy as np

    if any(np.dtype(d) == np.float32 for d in dtypes):
        return dict(rtol=5e-4, atol=5e-3)
    return dict(rtol=1e-5, atol=1e-10)


def normalized(y: torch.Tensor) -> torch.Tensor:
    """``y`` over its largest magnitude (at least 1e-30): the chained
    benchmarks feed each product back through this, on the device, so no
    step can be skipped and none reads the host."""
    return y / torch.clamp_min(y.abs().max(), 1e-30)


def spmv_share(y, ref, a, x, rtol: float = 1e-4, eps_mult: int = 384) -> float:
    """The largest ``|y - ref|`` as a share of the JAX suite's SpMV bound
    (a copy of ``tests/util.py:assert_spmv_close``: ``rtol * |ref|`` plus
    ``eps_mult`` f32 eps times the L1 mass of the row's 128-row window,
    plus 1e-6) for ``ref = a @ x``, ``a`` a scipy matrix (its duplicates
    summed on a copy); raises if it passes 1 or ``y`` is not finite.

    ``y`` and ``ref`` are (nrows,) for an operand ``x`` of (ncols,), or
    (k, nrows) for a batch ``x`` of (k, ncols): each row of ``y`` is then
    held to the bound of its own operand."""
    import numpy as np
    import scipy.sparse as sps

    def host(t):
        return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                          else t, np.float64)

    y, ref, x = host(y), host(ref), host(x)
    if y.shape != ref.shape or not np.all(np.isfinite(y)):
        raise AssertionError(f"SpMV output of shape {y.shape} against "
                             f"{ref.shape}, finite: {np.all(np.isfinite(y))}")
    a = sps.csr_matrix(a, dtype=np.float64, copy=True)
    a.sum_duplicates()
    # (k, nrows) L1 masses for a (k, ncols) batch, (nrows,) for one operand
    row_l1 = np.asarray(abs(a) @ np.abs(x).T).T
    n = row_l1.shape[-1]
    cum = np.concatenate([np.zeros(row_l1.shape[:-1] + (1,)),
                          np.cumsum(row_l1, -1)], -1)
    idx = np.arange(n)
    win_l1 = (cum[..., np.minimum(idx + 128, n)]
              - cum[..., np.maximum(idx - 127, 0)])
    tol = (rtol * np.abs(ref) + eps_mult * float(np.finfo(np.float32).eps)
           * win_l1 + 1e-6)
    share = float(np.max(np.abs(y - ref) / tol)) if n else 0.0
    if not share <= 1.0:
        raise AssertionError(f"SpMV outside the bound: share {share:.3g}")
    return share
