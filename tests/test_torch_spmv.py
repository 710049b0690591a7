"""The port's micro-block SpMV against the JAX package's Pallas kernel
(interpret mode, as the JAX tests run it on the CPU) on identical layout
arrays, and both against scipy, under ``assert_spmv_close`` (eps_mult
384, unchanged)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from csr_tpu.ops import microblock as ref_mb
from csr_tpu.ops import spmv as ref_spmv
from csr_tpu_torch.ops import _cuda, microblock as mb, spmv

from torch_util import Scipy, random_matrix
from util import assert_spmv_close

WINDOW_PAIR = [(w, p) for w in (128, 256) for p in (1, 2, 4)]


def _carried(window, pair, seed):
    """A reference layout, the same arrays as a port layout, the matrix
    and an operand."""
    a = random_matrix(300, 700, 0.03, seed=seed)
    ref = ref_mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                        window=window, pair=pair)
    port = mb.layout_from_arrays(
        np.asarray(ref.vals), np.asarray(ref.meta), np.asarray(ref.rbcb),
        ref.nrows, ref.ncols, ref.nnz, ref.n_microrows, ref.window, ref.pair,
        "cpu",
    )
    x = np.random.default_rng(seed).uniform(-1, 1, 700).astype(np.float32)
    return a, ref, port, x


# the Pallas interpreter takes ~8 s to trace each (window, pair): two of
# the six variants run against it, all six against scipy below
@pytest.mark.parametrize("window,pair", [(128, 2), (256, 1)])
def test_reference_matches_pallas_interpret(window, pair):
    a, ref, port, x = _carried(window, pair, seed=10 + window + pair)
    y_pallas = np.asarray(ref_spmv.spmv(ref, jnp.asarray(x), interpret=True))
    y_port = spmv.spmv_reference(port, torch.from_numpy(x)).numpy()
    expect = a.astype(np.float64) @ x
    assert_spmv_close(y_port, y_pallas, Scipy(a), x)
    assert_spmv_close(y_port, expect, Scipy(a), x)
    assert_spmv_close(y_pallas, expect, Scipy(a), x)


@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_reference_matches_scipy(window, pair):
    a, _, port, x = _carried(window, pair, seed=20 + window + pair)
    y = spmv.spmv_reference(port, torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (300,)
    assert_spmv_close(y.numpy(), a.astype(np.float64) @ x, Scipy(a), x)


def test_wrapper_on_cpu_runs_plain_version():
    _, _, port, x = _carried(128, 1, seed=30)
    before = spmv.launches
    xt = torch.from_numpy(x)
    assert torch.equal(spmv.spmv(port, xt), spmv.spmv_reference(port, xt))
    assert spmv.launches == before
    assert "spmv_microblock" not in _cuda._LIBS, "a CPU call built the CUDA kernel"


def test_wrapper_rejects_bad_operands():
    _, _, port, x = _carried(128, 1, seed=31)
    with pytest.raises(ValueError):
        spmv.spmv(port, torch.from_numpy(x[:-1]))
    meta_layout = mb.layout_from_arrays(
        port.vals.numpy(), port.meta.numpy(), port.rbcb.numpy(), port.nrows,
        port.ncols, port.nnz, port.n_microrows, port.window, port.pair, "meta",
    )
    with pytest.raises(ValueError):
        spmv.spmv(meta_layout, torch.zeros(port.ncols, device="meta"))


def test_padding_reads_no_operand():
    """Padding slots read no x: an inf where only padding points leaves
    the result finite (the JAX kernel would form 0 * inf there)."""
    a = random_matrix(300, 700, 0.03, seed=32).tolil()
    a[:, 0] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data)
    x = np.random.default_rng(32).uniform(-1, 1, 700).astype(np.float32)
    x[0] = np.inf
    y = spmv.spmv(layout, torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(y))
    x[0] = 0.0
    assert_spmv_close(y, a.astype(np.float64) @ x, Scipy(a), x)
