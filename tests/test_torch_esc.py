"""The port's expand-sort-compress SpGEMM (``ops/spgemm.py``) on the CPU:
its chunk plan against the JAX package's under the same budgets, the
structure of its products, empty operands, ``abt`` against ``ab`` of the
transpose, and its products against ``csr_tpu.ops.spgemm``'s and
scipy's, within the JAX suite's product tolerance
(``tests/torch_util.py:assert_product_close``).  The cases are those of
``tests/test_spgemm_internals.py``."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

import csr_tpu
from csr_tpu.ops import spgemm as ref_spgemm
from csr_tpu.test_utils import mm_pairs
from csr_tpu_torch import CSR, kernels
from csr_tpu_torch.ops import spgemm

from torch_util import assert_product_close, port_of, random_matrix
from util import to_dense

FEW = settings(max_examples=15, deadline=None)


@settings(max_examples=25, deadline=None)
@given(mm_pairs(max_shape=(40, 30, 40)), st.sampled_from([1, 5, 16, 64, 2**24]))
def test_chunk_splits_match_reference(pair, budget):
    """The same split list as the JAX package's for the same budget; every
    chunk within it unless it is one row."""
    A, B = pair
    a_rps = np.asarray(A.rowptrs)
    b_nnz = np.diff(np.asarray(B.rowptrs))
    a_cols = np.asarray(A.colinds)
    old, old_ref = spgemm.esc_chunk_entries, ref_spgemm.esc_chunk_entries
    try:
        spgemm.esc_chunk_entries = ref_spgemm.esc_chunk_entries = budget
        splits = spgemm._chunk_splits(a_rps, b_nnz, a_cols)
        assert splits == ref_spgemm._chunk_splits(a_rps, b_nnz, a_cols)
    finally:
        spgemm.esc_chunk_entries, ref_spgemm.esc_chunk_entries = old, old_ref
    assert splits[0] == 0 and splits[-1] == A.nrows
    assert all(b > a for a, b in zip(splits[:-1], splits[1:]))
    cum = spgemm._term_cum(a_rps, b_nnz, a_cols)
    for lo, hi in zip(splits[:-1], splits[1:]):
        assert cum[hi] - cum[lo] <= budget or hi - lo == 1


@FEW
@given(mm_pairs(max_shape=(30, 20, 30)), st.sampled_from([3, 40, 2**24]))
def test_esc_rows_structure(pair, budget):
    """Sorted, in-range, duplicate-free columns a row, valid row pointers,
    and the dense product, in one chunk or many."""
    A, B = (port_of(m) for m in pair)
    old = spgemm.esc_chunk_entries
    try:
        spgemm.esc_chunk_entries = budget
        C = spgemm.esc_mult_ab(A, B)
    finally:
        spgemm.esc_chunk_entries = old
    rps, cis = C.rowptrs.numpy(), C.colinds.numpy()
    assert (C.nrows, C.ncols) == (A.nrows, B.ncols)
    assert rps[0] == 0 and rps[-1] == C.nnz and np.all(np.diff(rps) >= 0)
    if C.nnz:
        assert cis.min() >= 0 and cis.max() < B.ncols
        for r in range(C.nrows):
            assert np.all(np.diff(cis[rps[r] : rps[r + 1]]) > 0)
    ref = to_dense(A) @ to_dense(B)
    np.testing.assert_allclose(to_dense(C), ref, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(ref).max(initial=0)))


def test_esc_empty_operands():
    A = CSR.from_coo([], [], None, (5, 4), device="cpu")
    B = CSR.from_coo([0], [2], [3.0], (4, 6), device="cpu")
    C = spgemm.esc_mult_ab(A, B)
    assert (C.nrows, C.ncols, C.nnz) == (5, 6, 0) and C.rowptrs.tolist() == [0] * 6
    C2 = spgemm.esc_mult_ab(B, CSR.from_coo([], [], None, (6, 3), device="cpu"))
    assert (C2.nrows, C2.ncols, C2.nnz) == (4, 3, 0)
    C3 = spgemm.esc_mult_ab(CSR.empty(0, 4, device="cpu"), B)
    assert (C3.nrows, C3.ncols, C3.nnz) == (0, 6, 0)
    with pytest.raises(ValueError):
        spgemm.esc_mult_ab(B, B)
    with pytest.raises(ValueError):
        spgemm.esc_mult_abt(B, A)


def test_esc_abt_matches_ab_transpose():
    rng = np.random.default_rng(3)
    a = sps.random(25, 18, 0.2, format="csr", random_state=rng, dtype=np.float32)
    b = sps.random(30, 18, 0.2, format="csr", random_state=rng, dtype=np.float32)
    A, B = CSR.from_scipy(a, device="cpu"), CSR.from_scipy(b, device="cpu")
    C = spgemm.esc_mult_abt(A, B)
    C2 = spgemm.esc_mult_ab(A, B.transpose())
    assert torch.equal(C.rowptrs, C2.rowptrs) and torch.equal(C.colinds, C2.colinds)
    np.testing.assert_allclose(to_dense(C), (a @ b.T).toarray(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("budget", [700, 2**24])
def test_esc_matches_reference(transpose, structure_only, budget, monkeypatch):
    """The port's ESC against the JAX package's, in several chunks and in
    one: the same entries, values within the product tolerance, and
    scipy's product."""
    a = random_matrix(120, 90, 0.06, seed=62)
    b = random_matrix(110 if transpose else 90, 90 if transpose else 110, 0.06,
                      seed=63, big_group=False)
    bv = None if structure_only else b.data
    ref_a = csr_tpu.CSR.from_scipy(a)
    ref_b = csr_tpu.CSR(b.shape[0], b.shape[1], b.nnz, b.indptr, b.indices, bv)
    monkeypatch.setattr(spgemm, "esc_chunk_entries", budget)
    monkeypatch.setattr(ref_spgemm, "esc_chunk_entries", budget)
    mul, ref_mul = ((spgemm.esc_mult_abt, ref_spgemm.esc_mult_abt) if transpose
                    else (spgemm.esc_mult_ab, ref_spgemm.esc_mult_ab))
    c, rc = mul(port_of(ref_a), port_of(ref_b)), ref_mul(ref_a, ref_b)
    assert c.values.dtype == torch.float32
    np.testing.assert_array_equal(c.rowptrs.numpy(), np.asarray(rc.rowptrs))
    np.testing.assert_array_equal(c.colinds.numpy(), np.asarray(rc.colinds))
    assert_product_close(c.values.numpy(), np.asarray(rc.values))
    bs = sps.csr_matrix((np.ones(b.nnz) if structure_only else b.data,
                         b.indices, b.indptr), shape=b.shape)
    assert_product_close(to_dense(c), (a @ (bs.T if transpose else bs)).toarray())


def test_esc_keeps_summed_zeros_and_multiply_drops_them(monkeypatch):
    """Terms that cancel leave a stored zero in ESC's output, as in the
    JAX package; ``CSR.multiply`` filters it.  f64 stays f64."""
    a = CSR.from_coo([0, 0], [0, 1], np.array([1.0, -1.0]), (1, 2), device="cpu")
    b = CSR.from_coo([0, 1, 1], [0, 0, 1], np.array([2.0, 2.0, 3.0]), (2, 2),
                     device="cpu")
    c = spgemm.esc_mult_ab(a, b)
    assert c.nnz == 2 and c.values.tolist() == [0.0, -3.0]
    assert c.values.dtype == torch.float64
    monkeypatch.setattr(spgemm, "max_dense_bytes", 1)
    with kernels.use_kernel("torch"):
        p = a.multiply(b)
    assert p.nnz == 1 and p.colinds.tolist() == [1] and p.values.tolist() == [-3.0]


def test_esc_emits_its_counts():
    seen = []
    kernels._listeners.append(lambda e, f: seen.append(f) if e == "esc" else None)
    try:
        a = random_matrix(40, 30, 0.1, seed=64, big_group=False)
        A = CSR.from_scipy(a, device="cpu")
        c = spgemm.esc_mult_abt(A, A)
    finally:
        kernels._listeners.pop()
    ones = a.astype(bool).astype(np.int64)
    terms = int((ones @ ones.T).sum())  # a term for each A[i, k], A[j, k] pair
    assert seen == [{"terms": terms, "chunks": 1, "nnz": c.nnz}]
