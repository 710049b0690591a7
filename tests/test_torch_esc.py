"""The port's expand-sort-compress SpGEMM (``ops/spgemm.py``) on the CPU:
its chunk plan against the JAX package's under the same budgets, the
structure of its products, empty operands, ``abt`` against ``ab`` of the
transpose, and its products against ``csr_tpu.ops.spgemm``'s and
scipy's, within the JAX suite's product tolerance
(``tests/torch_util.py:assert_product_close``).  The cases are those of
``tests/test_spgemm_internals.py``; the sort key's width (int32 local to
the chunk, or int64) at its boundary of 2^31 - 1 output cells a chunk."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from hypothesis import given, settings
import hypothesis.strategies as st

import csr_tpu
from csr_tpu.ops import spgemm as ref_spgemm
from csr_tpu.test_utils import mm_pairs
from csr_tpu_torch import CSR, kernels, tracing
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
    assert seen == [{"terms": terms, "chunks": 1, "nnz": c.nnz, "key_bits": 32}]


def _traced(fn, *args):
    """``fn(*args)`` with recording on: its result, the ``esc.keys*``
    counters and the ``esc`` events' fields."""
    seen = []
    kernels._listeners.append(lambda e, f: seen.append(f) if e == "esc" else None)
    rec = tracing.enable()
    try:
        out = fn(*args)
        counters = rec.snapshot()["counters"]
    finally:
        tracing.disable()
        kernels._listeners.pop()
    return out, {k: v for k, v in counters.items() if k.startswith("esc.keys")}, seen


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("budget", [700, 2**24])
def test_esc_narrow_keys_match_reference(transpose, budget, monkeypatch):
    """Every chunk of a product whose chunks span fewer than 2^31 output
    cells sorts int32 keys local to the chunk: one ``esc.keys32`` a chunk,
    no ``esc.keys64``, and the JAX package's entries in its order and
    scipy's product, in several chunks and in one."""
    a = random_matrix(120, 90, 0.06, seed=65)
    b = random_matrix(110 if transpose else 90, 90 if transpose else 110, 0.06,
                      seed=66, big_group=False)
    ref_a, ref_b = csr_tpu.CSR.from_scipy(a), csr_tpu.CSR.from_scipy(b)
    monkeypatch.setattr(spgemm, "esc_chunk_entries", budget)
    monkeypatch.setattr(ref_spgemm, "esc_chunk_entries", budget)
    mul, ref_mul = ((spgemm.esc_mult_abt, ref_spgemm.esc_mult_abt) if transpose
                    else (spgemm.esc_mult_ab, ref_spgemm.esc_mult_ab))
    c, keys, (event,) = _traced(mul, port_of(ref_a), port_of(ref_b))
    assert event["chunks"] > (1 if budget == 700 else 0)
    assert keys == {"esc.keys32": event["chunks"]} and event["key_bits"] == 32
    rc = ref_mul(ref_a, ref_b)
    np.testing.assert_array_equal(c.rowptrs.numpy(), np.asarray(rc.rowptrs))
    np.testing.assert_array_equal(c.colinds.numpy(), np.asarray(rc.colinds))
    assert_product_close(c.values.numpy(), np.asarray(rc.values))
    assert_product_close(to_dense(c), (a @ (b.T if transpose else b)).toarray())


#: B of the boundary cases: 3 rows of 2^31 - 1 columns, the last column
#: among them, so that a one-row chunk's largest key is 2^31 - 2
_WIDE = 2**31 - 1
_B_ROWS = [[0, _WIDE - 1], [5, 1000], [_WIDE - 1]]
#: A's rows: columns of B's rows (3, 3 and 4 terms)
_A_ROWS = [[0, 2], [1, 2], [0, 1]]


@pytest.mark.parametrize("a_rows,budget,widths", [
    (1, 2**24, [32]),      # 1 x (2^31 - 1) cells: fits
    (2, 2**24, [64]),      # 2 x (2^31 - 1): falls back
    (2, 3, [32, 32]),      # a row a chunk: each fits
    (3, 6, [64, 32]),      # rows 0-1, then row 2
])
def test_esc_key_width_at_the_boundary(a_rows, budget, widths, monkeypatch):
    """At ``ncols = 2^31 - 1`` a one-row chunk's keys fit int32 (its
    largest, 2^31 - 2, the last column's), a chunk of two rows takes the
    int64 key: each chunk counts its width, the event gives the widest,
    and both give scipy's entries in scipy's order."""
    rng = np.random.default_rng(67)
    b_cols = np.concatenate(_B_ROWS).astype(np.int32)
    b_vals = rng.integers(1, 5, len(b_cols)).astype(np.float32)
    b_rps = np.cumsum([0] + [len(r) for r in _B_ROWS])
    a_cols = np.concatenate(_A_ROWS[:a_rows]).astype(np.int32)
    a_vals = rng.integers(1, 5, len(a_cols)).astype(np.float32)  # no sum cancels
    a_rps = np.cumsum([0] + [len(r) for r in _A_ROWS[:a_rows]])
    A = CSR(a_rows, 3, len(a_cols), a_rps, a_cols, a_vals, device="cpu")
    B = CSR(3, _WIDE, len(b_cols), b_rps, b_cols, b_vals, device="cpu")
    monkeypatch.setattr(spgemm, "esc_chunk_entries", budget)
    sorted_keys = []
    compress = spgemm._compress

    def spy(key, *args):
        sorted_keys.append((key.dtype, int(key.max())))
        return compress(key, *args)

    monkeypatch.setattr(spgemm, "_compress", spy)
    c, keys, events = _traced(spgemm.esc_mult_ab, A, B)
    assert [8 * d.itemsize for d, _ in sorted_keys] == widths
    if widths == [32]:
        assert sorted_keys[0][1] == _WIDE - 1
    assert keys == {f"esc.keys{w}": widths.count(w) for w in set(widths)}
    assert [e["key_bits"] for e in events] == [max(widths)]
    # scipy's product over B's used columns, mapped back (in order)
    used = np.unique(b_cols)
    a_s = sps.csr_matrix((a_vals, a_cols, a_rps), shape=(a_rows, 3))
    b_s = sps.csr_matrix((b_vals, np.searchsorted(used, b_cols), b_rps),
                         shape=(3, len(used)))
    want = (a_s @ b_s).tocsr()
    want.sort_indices()
    assert (c.nrows, c.ncols) == (a_rows, _WIDE)
    np.testing.assert_array_equal(c.rowptrs.numpy(), want.indptr)
    np.testing.assert_array_equal(c.colinds.numpy(), used[want.indices])
    np.testing.assert_array_equal(c.values.numpy(), want.data)
