"""The port's row and column splits and ``partition_rows`` against the JAX
package's: equal exactly, on the same matrices."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from csr_tpu.parallel import partition as ref_part
from csr_tpu_torch.parallel import partition as part
from csr_tpu_torch.utils.serialization import parallel_from_arrays

from torch_util import (assert_same_partition, both_csr, fields_of,
                        random_matrix)


def _power_law(seed=23, nrows=256, ncols=2048, npr=64):
    """Power-law column skew (tests/test_distributed.py:147-174)."""
    rng = np.random.default_rng(seed)
    cols = np.minimum((ncols * rng.power(0.25, nrows * npr)).astype(np.int64),
                      ncols - 1).astype(np.int32)
    cols = np.sort(cols.reshape(nrows, npr), axis=1).reshape(-1)
    rowptr = np.arange(nrows + 1, dtype=np.int64) * npr
    return sps.csr_matrix((np.ones(nrows * npr, np.float32), cols, rowptr),
                          shape=(nrows, ncols))


CASES = {
    "uniform": lambda: random_matrix(90, 70, 0.1, seed=1, big_group=False),
    "power-law": _power_law,
    "few-rows": lambda: random_matrix(3, 40, 0.3, seed=2, big_group=False),
    "empty": lambda: sps.csr_matrix((12, 9), dtype=np.float32),
}


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_row_splits_equal(case, n_shards):
    a = CASES[case]()
    got = part.balanced_row_splits(a.indptr, n_shards)
    want = ref_part.balanced_row_splits(a.indptr, n_shards)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[-1] == a.shape[0] and np.all(np.diff(got) >= 0)


@pytest.mark.parametrize("align", [1, 128, 256])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_col_splits_equal(case, n_shards, align):
    a = CASES[case]()
    got = part.balanced_col_splits(a.indices, a.shape[1], n_shards, align)
    want = ref_part.balanced_col_splits(a.indices, a.shape[1], n_shards, align)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_power_law_buckets_stay_balanced():
    """nnz-balanced column splits keep the largest column shard near
    nnz / D where uniform splits blow up toward D times that."""
    a = _power_law()
    D = 8
    splits = part.balanced_col_splits(a.indices, a.shape[1], D)
    per = np.bincount(np.searchsorted(splits[1:], a.indices, side="right"),
                      minlength=D)
    uniform = np.bincount(np.minimum(a.indices // (-(-a.shape[1] // D)), D - 1),
                          minlength=D)
    assert per.max() <= 2 * a.nnz / D
    assert uniform.max() > 4 * a.nnz / D


@pytest.mark.parametrize("structure_only", [False, True])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("case", CASES)
def test_partition_rows_equal(case, n_shards, structure_only):
    """``n_shards`` = 8 exceeds the 3 rows of ``few-rows``."""
    ref_csr, csr = both_csr(CASES[case](), structure_only)
    ref = ref_part.partition_rows(ref_csr, n_shards)
    port = part.partition_rows(csr, n_shards)
    assert_same_partition(port, ref, part.DistCSR.TENSORS)
    carried = parallel_from_arrays(part.DistCSR, fields_of(ref))
    assert_same_partition(carried, ref, part.DistCSR.TENSORS)


def test_mesh_forms_and_checks():
    mesh = part.make_mesh(4, device="cpu")
    assert (mesh.n_shards, mesh.n_local, mesh.first) == (4, 4, 0)
    assert mesh.device == torch.device("cpu") and mesh.group is None
    want = (np.arange(4)[:, None] + np.arange(4)[None, :]) % 4
    np.testing.assert_array_equal(mesh.held.numpy(), want)
    assert mesh.held is mesh.held and mesh.held.dtype == torch.int32
    with pytest.raises(ValueError):
        part.make_mesh(0)
    with pytest.raises(ValueError):
        mesh.local(np.zeros((3, 2)))
    _, csr = both_csr(CASES["uniform"]())
    d = part.partition_rows(csr, 2)
    with pytest.raises(ValueError, match="shard"):
        part.check_sharded(d, mesh, "rowptrs")
    with pytest.raises(ValueError, match="all 2 shards"):
        part.collect_rows(d.nrows_local, torch.zeros(1, d.rows_per_shard))


def test_local_collectives_are_the_stack_ops():
    mesh = part.make_mesh(3, device="cpu")
    x = torch.arange(12.0).reshape(3, 4)
    assert torch.equal(mesh.all_gather(x), torch.arange(12.0))
    assert torch.equal(mesh.psum(x), x.sum(0))
    assert torch.equal(mesh.rotate(x)(), x[[1, 2, 0]])
    s = torch.arange(18.0).reshape(3, 3, 2)
    assert torch.equal(mesh.psum_scatter(s), s.sum(0))
