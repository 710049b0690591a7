"""The port's micro-block SpMM against the JAX package's Pallas kernel
(interpret mode, as the JAX tests run it on the CPU) on identical layout
arrays, and both against scipy, under the tolerance of
``tests/test_mult_dense.py`` (rtol 5e-4, atol 1e-4 times the largest
|result|, unchanged)."""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from csr_tpu.ops import microblock as ref_mb
from csr_tpu.ops import spmm as ref_spmm
from csr_tpu_torch.ops import _cuda, microblock as mb, spmm

from torch_util import assert_product_close, random_matrix

WINDOW_PAIR = [(w, p) for w in (128, 256) for p in (1, 2, 4)]


def _carried(window, pair, seed, n):
    """A reference layout, the same arrays as a port layout, the matrix
    (its (rb 0, cb 0) group spans two micro-rows) and a dense operand."""
    a = random_matrix(300, 700, 0.03, seed=seed)
    ref = ref_mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                        window=window, pair=pair)
    port = mb.layout_from_arrays(
        np.asarray(ref.vals), np.asarray(ref.meta), np.asarray(ref.rbcb),
        ref.nrows, ref.ncols, ref.nnz, ref.n_microrows, ref.window, ref.pair,
        "cpu",
    )
    b = np.random.default_rng(seed).uniform(-1, 1, (700, n)).astype(np.float32)
    return a, ref, port, b


# the Pallas interpreter takes a few seconds to trace each (window, pair):
# two of the six variants run against it, all six against scipy below
@pytest.mark.parametrize("window,pair", [(128, 2), (256, 1)])
def test_reference_matches_pallas_interpret(window, pair):
    a, ref, port, b = _carried(window, pair, seed=60 + window + pair, n=300)
    c_pallas = np.asarray(ref_spmm.spmm(ref, jnp.asarray(b), interpret=True))
    c_port = spmm.spmm_reference(port, torch.from_numpy(b))
    assert c_port.dtype == torch.float32 and c_port.shape == (300, 300)
    expect = a.astype(np.float64) @ b
    assert_product_close(c_port.numpy(), c_pallas)
    assert_product_close(c_port.numpy(), expect)
    assert_product_close(c_pallas, expect)


@pytest.mark.parametrize("n", [1, 50, 300])
@pytest.mark.parametrize("window,pair", WINDOW_PAIR)
def test_reference_matches_scipy(window, pair, n):
    a, _, port, b = _carried(window, pair, seed=70 + window + pair, n=n)
    c = spmm.spmm_reference(port, torch.from_numpy(b))
    assert c.dtype == torch.float32 and c.shape == (300, n)
    assert_product_close(c.numpy(), a.astype(np.float64) @ b)


def test_reference_casts_operand():
    """B of another dtype is cast to f32 first; the result is f32."""
    a, _, port, b = _carried(128, 1, seed=80, n=7)
    b64 = torch.from_numpy(b.astype(np.float64))
    c = spmm.spmm(port, b64)
    assert c.dtype == torch.float32
    assert torch.equal(c, spmm.spmm_reference(port, torch.from_numpy(b)))
    ci = spmm.spmm(port, torch.ones(700, 3, dtype=torch.int32))
    assert_product_close(ci.numpy(), a.astype(np.float64) @ np.ones((700, 3)))


def test_scatter_rows_chunks_agree(monkeypatch):
    a, _, port, b = _carried(256, 2, seed=81, n=50)
    whole = spmm.spmm_reference(port, torch.from_numpy(b))
    monkeypatch.setattr(spmm, "_CHUNK_ELEMS", 50 * 37)  # 37 entries a chunk
    chunked = spmm.spmm_reference(port, torch.from_numpy(b))
    assert_product_close(chunked.numpy(), whole.numpy())
    assert_product_close(chunked.numpy(), a.astype(np.float64) @ b)


def test_wrapper_on_cpu_runs_plain_version():
    _, _, port, b = _carried(128, 1, seed=82, n=20)
    before = spmm.launches
    bt = torch.from_numpy(b)
    assert torch.equal(spmm.spmm(port, bt), spmm.spmm_reference(port, bt))
    assert spmm.launches == before
    assert "spmm_microblock" not in _cuda._LIBS, "a CPU call built the kernel"


def test_wrapper_rejects_bad_operands():
    _, _, port, b = _carried(128, 1, seed=83, n=4)
    for bad in (b[:-1], b[:, 0], b[None]):
        with pytest.raises(ValueError):
            spmm.spmm(port, torch.from_numpy(np.ascontiguousarray(bad)))
    meta_layout = mb.layout_from_arrays(
        port.vals.numpy(), port.meta.numpy(), port.rbcb.numpy(), port.nrows,
        port.ncols, port.nnz, port.n_microrows, port.window, port.pair, "meta",
    )
    with pytest.raises(ValueError):
        spmm.spmm(meta_layout, torch.zeros(port.ncols, 4, device="meta"))


@pytest.mark.parametrize("window", [128, 256])
def test_padding_reads_no_b(window):
    """Padding slots read no B: an inf in a row of B that only padding
    points to leaves the product finite (a kernel that read B there would
    form 0 * inf)."""
    a = random_matrix(300, 700, 0.03, seed=84).tolil()
    a[:, 0] = 0
    a = a.tocsr()
    a.eliminate_zeros()
    layout = mb.build_microblocks_host(300, 700, a.indptr, a.indices, a.data,
                                       window=window)
    b = np.random.default_rng(84).uniform(-1, 1, (700, 9)).astype(np.float32)
    b[0] = np.inf
    c = spmm.spmm(layout, torch.from_numpy(b)).numpy()
    assert np.all(np.isfinite(c))
    b[0] = 0.0
    assert_product_close(c, a.astype(np.float64) @ b)


def test_empty_layout_and_zero_width():
    empty = mb.build_microblocks_host(5, 7, np.zeros(6, np.int64),
                                      np.zeros(0, np.int32), None)
    assert torch.equal(spmm.spmm(empty, torch.ones(7, 3)), torch.zeros(5, 3))
    _, _, port, _ = _carried(128, 1, seed=85, n=1)
    assert spmm.spmm(port, torch.ones(700, 0)).shape == (300, 0)


def test_every_source_has_an_entry():
    """Each ``csrc/*.cu`` is a kernel that ``_cuda`` builds and binds."""
    stems = sorted(p.stem for p in pathlib.Path(_cuda.CSRC).glob("*.cu"))
    assert stems == sorted(_cuda.ENTRIES)
