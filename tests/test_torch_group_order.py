"""The micro-block SpMM's order of groups: every packed layout carries
``order``, its groups of 32 micro-rows sorted by the column window of
their first micro-row (``ops/microblock.py:group_order``), and the
kernel's blocks take the groups in it.

On the CPU, at the Netflix Prize's shape cut small
(``test_torch_netflix_shape.py``'s laws), at a random matrix and at
``spmv.build_large_layouts``'s chunks: the order against a sort on the
host, the packing paths that carry it, the card's check of it, and its
life with the layout in the matrix's set of forms.
"""

import dataclasses

import numpy as np
import pytest
import torch

import csr_tpu_torch.kernels as kernels
from cardbench import generate
from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import cuda as cuda_k
from csr_tpu_torch.ops import microblock as mb, spmv

from torch_util import kept

#: the Netflix laws at a small size, as test_torch_netflix_shape.py has them
SMALL = {"users": 3000, "items": 400, "ratings": 60000}
CAP = 200
SEED = 3_000_000_022
LAYOUTS = ["Rt w128", "Rt w256", "random"]


def _netflix_small():
    cfg = generate.load_config("netflix")
    cfg.update(SMALL, user_degree=dict(cfg["user_degree"], cap=CAP))
    trip = generate.ratings(cfg, SEED, "cpu")
    return CSR.from_coo(trip["rows"], trip["cols"], trip["vals"], shape=trip["shape"],
                        device="cpu")


def _random(nrows=700, ncols=9000, nnz=40_000, seed=22):
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, nrows, nnz))
    cols = rng.integers(0, ncols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    rp = np.searchsorted(rows, np.arange(nrows + 1)).astype(np.int64)
    return nrows, ncols, rp, cols, vals


@pytest.fixture(scope="module")
def netflix_small():
    return _netflix_small()


@pytest.fixture(scope="module")
def layouts(netflix_small):
    """Layouts with many groups a row window: the small Netflix shape's
    transpose at both windows, and a random matrix."""
    rt = netflix_small.transpose()
    rp, cols, vals = rt.host_arrays()
    out = {f"Rt w{w}": mb.build_microblocks_host(rt.nrows, rt.ncols, rp, cols, vals,
                                                 window=w) for w in (128, 256)}
    out["random"] = mb.build_microblocks_host(*_random())
    return out


def _assert_column_order(layout):
    """``layout.order`` is int32 ``(n_microrows // 32,)`` on the layout's
    device, a permutation of the groups; each group's first ``cb`` never
    falls along it, nor its ``rb`` within one ``cb``, and groups of the
    same (cb, rb) keep the packer's order: numpy's stable sort of the
    same keys."""
    groups = layout.n_microrows // mb.ACC_GROUP
    order = layout.order
    assert order.dtype == torch.int32 and order.shape == (groups,)
    assert order.device == layout.device and order.is_contiguous()
    got = order.cpu().numpy()
    assert np.array_equal(np.sort(got), np.arange(groups))
    first = layout.rbcb[: layout.n_microrows : mb.ACC_GROUP].cpu().numpy()
    rb, cb = first >> 16, first & 0xFFFF
    assert np.array_equal(got, np.lexsort((np.arange(groups), rb, cb)))
    assert np.all(np.diff(cb[got]) >= 0)
    same = np.diff(cb[got]) == 0
    assert np.all(np.diff(rb[got])[same] >= 0)
    return got


@pytest.mark.parametrize("name", LAYOUTS)
def test_order_sorts_groups_by_first_column_window_then_row_window(layouts, name):
    got = _assert_column_order(layouts[name])
    # the order moves groups: row windows of several groups are interleaved
    assert not np.array_equal(got, np.arange(got.size))


def test_empty_matrix_has_an_empty_order():
    layout = mb.build_microblocks_host(5, 7, np.zeros(6, np.int64), np.zeros(0, np.int32),
                                       np.zeros(0, np.float32))
    assert layout.n_microrows == 0
    assert layout.order.dtype == torch.int32 and layout.order.shape == (0,)
    mb.check_on_card(layout)


def test_native_and_numpy_packers_carry_the_same_order(monkeypatch):
    """Both packers give the same bytes, and so the same order."""
    from csr_tpu_torch import native

    assert native.available()
    args = _random(seed=23)
    packed = mb.build_microblocks_host(*args)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    plain = mb.build_microblocks_host(*args)
    assert torch.equal(packed.rbcb, plain.rbcb)
    assert torch.equal(packed.order, plain.order)
    _assert_column_order(plain)


def test_large_layouts_each_carry_their_order():
    """Every (chunk, panel) layout of ``build_large_layouts`` is packed on
    its own and carries its own order."""
    nrows, ncols, rp, cols, vals = _random(nrows=1000, ncols=1500, nnz=60_000, seed=24)
    chunks = spmv.build_large_layouts(nrows, ncols, rp, cols, vals, max_windows=4)
    layouts = [lay for _, panels in chunks for _, lay in panels]
    assert len(chunks) >= 2 and len(layouts) >= 4
    for layout in layouts:
        _assert_column_order(layout)


@pytest.mark.parametrize("fault", ["short", "int64", "2d", "strided"])
def test_check_on_card_refuses_a_malformed_order(layouts, fault):
    """The card's check holds the order to the kernel's reading of it:
    one int32 a group, contiguous, on the layout's device."""
    layout = layouts["random"]
    mb.check_on_card(layout)
    good = layout.order
    bad = {"short": good[:-1], "int64": good.long(), "2d": good.view(1, -1),
           "strided": good.repeat(2)[::2]}[fault]
    with pytest.raises(ValueError, match="order"):
        mb.check_on_card(dataclasses.replace(layout, order=bad))


def test_the_matrix_layouts_carry_the_order_and_go_with_the_stamp(netflix_small):
    """The layouts the ``cuda`` backend keeps for a matrix and its
    transpose carry their orders; a moved stamp drops them with every
    form, and the next product packs them again, with their orders."""
    r = CSR(netflix_small.nrows, netflix_small.ncols, netflix_small.nnz,
            netflix_small.rowptrs.clone(), netflix_small.colinds.clone(),
            netflix_small.values.clone())
    q = torch.randn(r.ncols, 50, generator=torch.Generator().manual_seed(5))
    p = torch.randn(r.nrows, 50, generator=torch.Generator().manual_seed(6))
    with kernels.use_kernel("cuda"):
        first = r.mult_dense(q)
        torch.func.vmap(r.mult_vec_t)(p.T)
        layout, layout_t = kept(r, "layout"), kept(r, "layout_t")
        for lay in (layout, layout_t):
            _assert_column_order(lay)
        assert r.mult_dense(q) is not None and kept(r, "layout") is layout
        r.values.mul_(2.0)  # the stamp moves
        assert kept(r) == {}
        again = r.mult_dense(q)
    assert kept(r, "layout") is not layout
    assert torch.equal(kept(r, "layout").order, layout.order)
    assert cuda_k._cached_layout(r) is kept(r, "layout")
    np.testing.assert_allclose(again.numpy(), 2 * first.numpy(), rtol=1e-6, atol=1e-5)
