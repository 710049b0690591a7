"""A CSR under the ``torch.func`` transforms: the counterparts of the nine
tests of ``tests/test_jit.py``.

The JAX package registers ``CSR`` as a pytree so that it crosses ``jit``
boundaries and works under ``vmap`` and ``grad``.  The port registers it
with ``torch.utils._pytree``, so that ``torch.func.vmap`` and
``torch.func.grad`` take and return it; eager execution is PyTorch's
model, so where the JAX test traces a function under ``jax.jit`` the test
here runs it under ``torch.func.vmap`` or ``torch.func.grad``.  The same
seeded inputs go through both packages, compared within
``tests/util.py:dense_tols``; the JAX side runs on ``xla`` and, for
``vmap``, on ``pallas`` in interpret mode, as the JAX tests run it on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
import torch.utils._pytree as pytree

from csr_tpu import CSR as RefCSR
from csr_tpu.kernels import get_kernel as ref_get_kernel
from csr_tpu.kernels import use_kernel as ref_use_kernel
from csr_tpu_torch import CSR
from csr_tpu_torch.kernels import get_kernel, use_kernel
from csr_tpu_torch.ops import spmm as spmm_op, spmv as spmv_op

from torch_util import kept
from util import dense_tols


@pytest.fixture(scope="module")
def mat():
    """The 50 x 40 matrix of tests/test_jit.py, in both packages."""
    rng = np.random.default_rng(42)
    m = sps.random(50, 40, 0.15, format="csr", random_state=rng)
    port = CSR(50, 40, m.nnz, m.indptr, m.indices, m.data.astype(np.float32),
               device="cpu")
    return RefCSR.from_scipy(m), port, m.toarray().astype(np.float32)


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), ref, **dense_tols(ref, np.float32))


def test_pytree_round_trip(mat):
    """Leaves ``(rowptrs, colinds, values)``, context ``(nrows, ncols)``;
    unflatten drops the host copy and gives the same matrix."""
    _, csr, dense = mat
    assert kept(csr, "host") is not None
    leaves, spec = pytree.tree_flatten(csr)
    assert len(leaves) == 3
    assert leaves[0] is csr.rowptrs and leaves[1] is csr.colinds
    assert leaves[2] is csr.values
    out = pytree.tree_unflatten(leaves, spec)
    assert isinstance(out, CSR) and out is not csr
    assert (out.nrows, out.ncols, out.nnz) == (50, 40, csr.nnz)
    assert kept(out, "host") is None
    np.testing.assert_array_equal(out.to_scipy().toarray(), dense)
    x = torch.linspace(-1, 1, 40)
    torch.testing.assert_close(out.mult_vec(x), csr.mult_vec(x))


def test_structure_only_pytree(mat):
    """A structure-only CSR flattens to its two array leaves and comes
    back with no values, as the JAX flatten does."""
    ref, csr, _ = mat
    s = csr.copy(include_values=False)
    leaves, spec = pytree.tree_flatten(s)
    ref_leaves, _ = jax.tree_util.tree_flatten(ref.copy(include_values=False))
    assert len(leaves) == len(ref_leaves) == 2
    r = pytree.tree_unflatten(leaves, spec)
    assert r.values is None and r.nnz == csr.nnz


def test_csr_through_vmap_boundary(mat):
    """A CSR goes into and out of a vmapped function as a pytree: its
    structure unbatched, its values batched (the JAX test passes it
    across a jit boundary)."""
    ref, csr, _ = mat

    def scale(c, a):
        return CSR(c.nrows, c.ncols, c.nnz, c.rowptrs, c.colinds,
                   c.values * a, _cast=False)

    a = torch.tensor([2.0, -0.5, 3.0])
    out_dims = pytree.tree_unflatten([None, None, 0],
                                     pytree.tree_flatten(csr)[1])
    out = torch.func.vmap(scale, in_dims=(None, 0), out_dims=out_dims)(csr, a)
    assert isinstance(out, CSR)
    assert (out.nrows, out.ncols, out.nnz) == (csr.nrows, csr.ncols, csr.nnz)
    assert out.rowptrs is csr.rowptrs and out.values.shape == (3, csr.nnz)

    ref_scale = jax.jit(lambda c, s: RefCSR(c.nrows, c.ncols, c.nnz, c.rowptrs,
                                             c.colinds, c.values * s, _cast=False))
    for i, s in enumerate(a.tolist()):
        np.testing.assert_allclose(out.values[i].numpy(),
                                   np.asarray(ref_scale(ref, s).values), rtol=1e-6)


@pytest.fixture(scope="module")
def batched_refs(mat):
    """``jax.vmap`` of ``mult_vec`` and ``mult_vec_t`` over a batch of
    operands on the JAX package's ``xla`` and ``pallas`` backends."""
    ref, _, _ = mat
    rng = np.random.default_rng(2)
    X = rng.standard_normal((5, 40)).astype(np.float32)
    Xt = rng.standard_normal((5, 50)).astype(np.float32)
    out = {}
    for k in ("xla", "pallas"):
        with ref_use_kernel(k):
            out[k] = (np.asarray(jax.vmap(lambda v: ref.mult_vec(v))(jnp.asarray(X))),
                      np.asarray(jax.vmap(lambda v: ref.mult_vec_t(v))(jnp.asarray(Xt))))
    return X, Xt, out


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("in_dim", [0, 1])
def test_vmap_mult_vec(mat, batched_refs, kernel, transpose, in_dim):
    """``torch.func.vmap`` of ``mult_vec`` and ``mult_vec_t`` over a batch
    of operands, on both port backends (the cuda backend's plain versions
    on the CPU), against ``jax.vmap`` on ``xla`` and ``pallas``, whichever
    axis the batch is on."""
    _, csr, dense = mat
    X, Xt, refs = batched_refs
    batch = Xt if transpose else X
    arg = torch.from_numpy(batch if in_dim == 0 else batch.T.copy())
    with use_kernel(kernel):
        fn = (lambda v: csr.mult_vec_t(v)) if transpose else (lambda v: csr.mult_vec(v))
        Y = torch.func.vmap(fn, in_dims=in_dim)(arg)
    assert Y.shape == (5, 40 if transpose else 50)
    for k in ("xla", "pallas"):
        _close(Y, refs[k][1 if transpose else 0])
    _close(Y, batch @ (dense if transpose else dense.T))


def test_vmap_on_cuda_backend_is_one_spmm(mat, monkeypatch):
    """On the cuda backend a vmapped batch of k operands runs the SpMM
    wrapper once, on B = X^T (ncols, k), and the SpMV wrapper not at all,
    and emits one trace event of route ``kernel`` with ``n = k``, as
    ``mult_dense`` does; outside vmap a product runs the SpMV wrapper
    once."""
    from csr_tpu_torch import kernels
    from csr_tpu_torch.kernels import cuda as cuda_k

    _, csr, dense = mat
    calls = []
    real_spmm, real_spmv = spmm_op.spmm, spmv_op.spmv

    def spmm(layout, b):
        calls.append(("spmm", tuple(b.shape)))
        return real_spmm(layout, b)

    def spmv(layout, x, out=None):
        calls.append(("spmv", tuple(x.shape)))
        return real_spmv(layout, x, out)

    monkeypatch.setattr(spmm_op, "spmm", spmm)
    monkeypatch.setattr(spmv_op, "spmv", spmv)
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))  # the micro-block route
    X = torch.from_numpy(np.random.default_rng(6).standard_normal((8, 40))
                         .astype(np.float32))
    events = []
    kernels._listeners.append(
        lambda e, f: events.append((e, f)) if e.startswith("mult_vec") else None)
    try:
        with use_kernel("cuda"):
            Y = torch.func.vmap(lambda v: csr.mult_vec(v))(X)
            assert calls == [("spmm", (40, 8))]
            assert events == [("mult_vec", {"route": "kernel", "shape": (50, 40),
                                            "n": 8})]
            calls.clear()
            events.clear()
            y = csr.mult_vec(X[0])
            assert calls == [("spmv", (40,))] and events == []
            calls.clear()
            torch.func.vmap(lambda v: csr.mult_vec_t(v), in_dims=1)(
                torch.ones(50, 3))
            assert calls == [("spmm", (50, 3))]
            assert events == [("mult_vec_t", {"route": "kernel",
                                              "shape": (40, 50), "n": 3})]
    finally:
        kernels._listeners.pop()
    _close(Y, X.numpy() @ dense.T)
    _close(y, dense @ X[0].numpy())


def test_mult_dense_under_grad(mat):
    """``mult_dense`` on a CSR passed through ``torch.func.grad``: the
    product matches the JAX package's jitted one, and the gradient of
    ``sum(W * (A B))`` in B is ``A^T W``."""
    ref, csr, dense = mat
    rng = np.random.default_rng(1)
    B = rng.standard_normal((40, 8)).astype(np.float32)
    W = rng.standard_normal((50, 8)).astype(np.float32)

    def loss(c, b):
        y = c.mult_dense(b)
        return (torch.from_numpy(W) * y).sum(), y

    with use_kernel("torch"):
        gb, y = torch.func.grad(loss, argnums=1, has_aux=True)(csr, torch.from_numpy(B))
    with ref_use_kernel("xla"):
        y_ref = np.asarray(jax.jit(lambda c, b: c.mult_dense(b))(ref, jnp.asarray(B)))
    _close(y, y_ref)
    _close(y, dense @ B)
    _close(gb, dense.T @ W)


def test_row_ops_vmapped(mat):
    """``row`` and ``row_mask`` on a batch of value arrays over one
    structure, against the JAX package's row ops on a traced CSR."""
    ref, csr, dense = mat
    scales = torch.tensor([1.0, -2.0])
    V = csr.values[None, :] * scales[:, None]

    def rows(vs):
        c = CSR(csr.nrows, csr.ncols, csr.nnz, csr.rowptrs, csr.colinds, vs,
                _cast=False)
        return c.row(3), c.row_mask(3), c.row([3, 7])

    r, m, rr = torch.func.vmap(rows)(V)
    r_ref, m_ref = jax.jit(lambda c: (c.row(3), c.row_mask(3)))(ref)
    for i, s in enumerate(scales.tolist()):
        np.testing.assert_allclose(r[i].numpy(), s * np.asarray(r_ref), rtol=1e-6)
        np.testing.assert_array_equal(m[i].numpy(), np.asarray(m_ref))
        np.testing.assert_allclose(rr[i].numpy(), s * dense[[3, 7]], rtol=1e-6)


def test_grad_through_mult_vec(mat):
    """SpMV on the torch backend is differentiable in the values and the
    operand, as the JAX package's ``xla`` backend is under
    ``jax.grad(..., allow_int=True)``.  ``torch.func.grad`` cannot take
    the CSR's integer leaves (it makes every input leaf require grad, and
    only floating tensors can), so this takes ``torch.autograd.grad`` over
    ``(values, x)``; ``torch.func.grad`` over the operand alone is checked
    beside it."""
    ref, csr, dense = mat
    rng = np.random.default_rng(3)
    x = rng.standard_normal(40).astype(np.float32)
    w = rng.standard_normal(50).astype(np.float32)

    with ref_use_kernel("xla"):
        gc, gx_ref = jax.grad(
            lambda c, v: jnp.vdot(jnp.asarray(w), c.mult_vec(v)),
            argnums=(0, 1), allow_int=True)(ref, jnp.asarray(x))

    vals = csr.values.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    c = CSR(csr.nrows, csr.ncols, csr.nnz, csr.rowptrs, csr.colinds, vals,
            _cast=False)
    with use_kernel("torch"):
        y = c.mult_vec(xt)
        gv, gx = torch.autograd.grad((torch.from_numpy(w) * y).sum(), (vals, xt))
        gx_func = torch.func.grad(
            lambda v: (torch.from_numpy(w) * csr.mult_vec(v)).sum())(torch.from_numpy(x))
    _close(gx, np.asarray(gx_ref))
    _close(gx_func, dense.T @ w)
    _close(gv, np.asarray(gc.values))
    rows = np.repeat(np.arange(csr.nrows), np.diff(csr.rowptrs.numpy()))
    _close(gv, w[rows] * x[csr.colinds.numpy()])

    # mult_vec_t: d/dv (x^T A^T v) = A x, d/dvalues = v[rows] * x[cols]
    vt = torch.from_numpy(w).requires_grad_()
    with use_kernel("torch"):
        gvt, gv2 = torch.autograd.grad((torch.from_numpy(x) * c.mult_vec_t(vt)).sum(),
                                       (vt, vals))
    _close(gvt, dense @ x)
    _close(gv2, w[rows] * x[csr.colinds.numpy()])


@pytest.mark.parametrize("op", ["mult_vec", "mult_vec_t", "mult_dense"])
@pytest.mark.parametrize("needs_grad", ["operand", "values"])
def test_cuda_backend_refuses_grad(mat, op, needs_grad):
    """The cuda backend has no backward, as the JAX ``pallas`` backend has
    none: a product whose operand or values require grad raises
    ValueError naming the torch backend, instead of returning a result
    with no ``grad_fn``.  With grad mode off it runs."""
    _, csr, dense = mat
    n = {"mult_vec": 40, "mult_vec_t": 50, "mult_dense": 40}[op]
    operand = torch.ones((n, 3) if op == "mult_dense" else n)
    vals = csr.values.clone()
    if needs_grad == "operand":
        operand.requires_grad_()
    else:
        vals.requires_grad_()
    c = CSR(csr.nrows, csr.ncols, csr.nnz, csr.rowptrs, csr.colinds, vals,
            _cast=False)
    with use_kernel("cuda"):
        with pytest.raises(ValueError, match="torch backend"):
            getattr(c, op)(operand)
        with torch.no_grad():
            out = getattr(c, op)(operand)
    ref = dense.T @ np.ones(50) if op == "mult_vec_t" else dense @ np.ones(
        (40, 3) if op == "mult_dense" else 40)
    _close(out, ref.astype(np.float32))


def test_static_kernel_module_vmapped(mat):
    """The kernel module called directly (handle, product, release) inside
    a vmapped function, as the JAX test calls it inside jit."""
    ref, csr, dense = mat
    K = get_kernel("torch")
    X = np.random.default_rng(4).standard_normal((3, 40)).astype(np.float32)

    def f(v):
        h = K.to_handle(csr)
        try:
            return K.mult_vec(h, v)
        finally:
            K.release_handle(h)

    Y = torch.func.vmap(f)(torch.from_numpy(X))
    RK = ref_get_kernel("xla")

    @jax.jit
    def g(c, v):
        h = RK.to_handle(c)
        try:
            return RK.mult_vec(h, v)
        finally:
            RK.release_handle(h)

    for i in range(3):
        _close(Y[i], np.asarray(g(ref, jnp.asarray(X[i]))))
    _close(Y, X @ dense.T)


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_from_coo_vmapped(kernel):
    """A CSR built from COO arrays inside a vmapped function, then
    multiplied by the batched operand."""
    rng = np.random.default_rng(5)
    rows = np.sort(rng.integers(0, 20, 60)).astype(np.int32)
    cols = rng.integers(0, 30, 60).astype(np.int32)
    vals = rng.standard_normal(60).astype(np.float32)
    X = rng.standard_normal((4, 30)).astype(np.float32)

    def build_and_apply(x):
        m = CSR.from_coo(rows, cols, vals, shape=(20, 30), device="cpu")
        return m.mult_vec(x)

    with use_kernel(kernel):
        Y = torch.func.vmap(build_and_apply)(torch.from_numpy(X))

    @jax.jit
    def ref_apply(x):
        return RefCSR.from_coo(rows, cols, vals, shape=(20, 30)).mult_vec(x)

    with ref_use_kernel("xla"):
        for i in range(4):
            _close(Y[i], np.asarray(ref_apply(jnp.asarray(X[i]))))
    dense = np.zeros((20, 30), np.float32)
    np.add.at(dense, (rows, cols), vals)
    _close(Y, X @ dense.T)


@pytest.mark.parametrize("transpose", [False, True])
def test_vmap_large_route_is_one_spmm_a_panel(monkeypatch, transpose):
    """Past the large path's budget (2 windows here) a vmapped batch runs
    the SpMM wrapper once a (chunk, panel) layout, and no SpMV."""
    from csr_tpu_torch.kernels import cuda as cuda_k

    monkeypatch.setattr(cuda_k, "_LARGE_WINDOWS", 2)
    # its panels' layouts are mostly padding: hold it on the micro-block
    # route, whose vmap rule this checks
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER", float("inf"))
    monkeypatch.setattr(cuda_k, "_CSR_CROSSOVER_LARGE", float("inf"))
    m = sps.random(512, 640, 0.02, format="csr", dtype=np.float32,
                   random_state=np.random.default_rng(7))
    c = CSR.from_scipy(m, device="cpu")
    n_in = 512 if transpose else 640
    X = torch.from_numpy(np.random.default_rng(8).standard_normal((6, n_in))
                         .astype(np.float32))
    calls = []
    real_spmm, real_spmv = spmm_op.spmm, spmv_op.spmv
    monkeypatch.setattr(spmm_op, "spmm",
                        lambda lay, b: calls.append("spmm") or real_spmm(lay, b))
    monkeypatch.setattr(spmv_op, "spmv",
                        lambda lay, x, out=None: calls.append("spmv")
                        or real_spmv(lay, x, out))
    from csr_tpu_torch import kernels

    events = []
    kernels._listeners.append(
        lambda e, f: events.append((e, f)) if e.startswith("mult_vec") else None)
    try:
        with use_kernel("cuda"):
            fn = (lambda v: c.mult_vec_t(v)) if transpose else (lambda v: c.mult_vec(v))
            Y = torch.func.vmap(fn)(X)
            panels = sum(len(p) for _, p in cuda_k._cached_large(c, transpose))
    finally:
        kernels._listeners.pop()
    assert panels > 1 and calls == ["spmm"] * panels
    shape = (640, 512) if transpose else (512, 640)
    assert events == [
        ("mult_vec_t" if transpose else "mult_vec",
         {"route": "kernel", "shape": shape, "n": 6})]
    dense = m.toarray()
    _close(Y, X.numpy() @ (dense if transpose else dense.T))
