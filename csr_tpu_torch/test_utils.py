"""
Hypothesis strategies for property-based tests of the port (counterpart
of :mod:`csr_tpu.test_utils`).

The same names and the same envelope as the JAX package's module: shapes
up to 80 x 80, density up to 0.5, value magnitudes up to 1e3, matrices
with and without stored values.  A matrix is drawn as numpy arrays (a
shape, unique cells scattered over the grid in row-major order, finite
values) and built with :meth:`csr_tpu_torch.CSR.from_coo` on the device
the caller picks, the CPU by default, so the same draw can also build the
JAX package's matrix.

Where it differs from the JAX module, and why:

* f8 values are always drawn: the port never narrows a 64-bit tensor
  (:mod:`csr_tpu_torch.dtypes`), so it has no x64 switch to consult;
* subnormal values stay excluded, although the card keeps them, so that
  the port's property results stay comparable with the JAX suite's (the
  TPU flushes them to zero);
* :func:`has_memory` reads the host's memory from ``os.sysconf`` instead
  of ``psutil``, which the machine with the card does not have.
"""

from __future__ import annotations

import os

import hypothesis.extra.numpy as nph
import hypothesis.strategies as st
import numpy as np
import scipy.sparse as sps
from hypothesis import HealthCheck, settings

from .csr import CSR

#: test-matrix size ceiling (rows and columns)
DIM_LIMIT = 80
#: test-matrix density ceiling
DENSITY_LIMIT = 0.5
#: value magnitude ceiling
VALUE_LIMIT = 1.0e3


def dims(limit: int = DIM_LIMIT):
    """A matrix-dimension strategy: small enough for dense oracles."""
    return st.integers(1, limit)


def value_dtypes():
    """Value dtypes: f4 and f8 (the port keeps f8 as it is)."""
    return st.sampled_from([np.dtype("f4"), np.dtype("f8")])


def fractions(**kwargs):
    """Floats in [0, 1] (densities, probabilities)."""
    return st.floats(0, 1, **kwargs)


def _resolve(draw, spec, default):
    """Accept an int, a strategy, a sequence of choices, or None."""
    if spec is None:
        return draw(default)
    if isinstance(spec, st.SearchStrategy):
        return draw(spec)
    if isinstance(spec, (list, tuple)):
        return draw(st.sampled_from(list(spec)))
    return spec


@st.composite
def finite_arrays(draw, shape, dtype=np.float64(), min_value=-VALUE_LIMIT,
                  max_value=VALUE_LIMIT, **kwargs):
    """Finite-valued arrays of the given shape, NaN/inf-free."""
    dtype = np.dtype(dtype)
    elements = nph.from_dtype(
        dtype, min_value=min_value, max_value=max_value,
        allow_infinity=False, allow_nan=False, **kwargs,
    )
    return draw(nph.arrays(dtype, shape, elements=elements))


@st.composite
def grid_cells(draw, nrows: int, ncols: int, count: int):
    """``count`` distinct (row, col) coordinates on an nrows x ncols grid,
    drawn as a set of row-major linear ids and decoded: uniform placement,
    shrinking toward the top-left corner."""
    ids = draw(
        st.sets(st.integers(0, nrows * ncols - 1),
                min_size=count, max_size=count)
    )
    linear = np.fromiter(ids, dtype=np.int64, count=count)
    return (
        (linear // ncols).astype(np.int32),
        (linear % ncols).astype(np.int32),
    )


@st.composite
def coo_arrays(draw, nrows=None, ncols=None, nnz=None, max_nnz=None,
               max_density=DENSITY_LIMIT, values=None, dtype=None):
    """``(rows, cols, vals, shape)`` of a matrix as numpy arrays, cells
    unique, ``vals`` None for a structure-only matrix and free of zeros
    otherwise.  Arguments as for :func:`csrs`."""
    nrows = _resolve(draw, nrows, dims())
    ncols = _resolve(draw, ncols, dims())

    cap = int(np.ceil(nrows * ncols * max_density))
    if max_nnz is not None:
        cap = min(cap, max_nnz)
    nnz = _resolve(draw, nnz, st.integers(0, cap))
    nnz = min(nnz, nrows * ncols)

    rows, cols = draw(grid_cells(nrows, ncols, nnz)) if nnz else (
        np.zeros(0, np.int32), np.zeros(0, np.int32)
    )

    if values is None:
        values = draw(st.booleans())
    vals = None
    if values:
        vdtype = _resolve(draw, dtype, value_dtypes())
        vals = draw(finite_arrays(nnz, dtype=vdtype, allow_subnormal=False))
        keep = vals != 0.0  # from_coo stores explicit zeros; exclude here
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    return rows, cols, vals, (nrows, ncols)


@st.composite
def csrs(draw, nrows=None, ncols=None, nnz=None, max_nnz=None,
         max_density=DENSITY_LIMIT, values=None, dtype=None, device="cpu"):
    """Draw a CSR matrix on ``device`` (the CPU by default).

    Every argument but ``device`` accepts a fixed value, a strategy, or
    None for the default envelope.  ``values=None`` draws matrices with
    and without stored values (structure-only = implicit ones)."""
    rows, cols, vals, shape = draw(coo_arrays(nrows, ncols, nnz, max_nnz,
                                              max_density, values, dtype))
    return CSR.from_coo(rows, cols, vals, shape, device=device)


@st.composite
def mm_pairs(draw, max_shape=(100, 100, 100), dtype=None, **kwargs):
    """A conformable (A, B) pair for multiply tests: A is r x m, B is
    m x c, both with stored values of one shared dtype (f8 unless
    ``dtype`` says otherwise: the port does not narrow)."""
    mr, mm, mc = max_shape
    r = draw(dims(mr))
    m = draw(dims(mm))
    c = draw(dims(mc))
    if dtype is None:
        dtype = np.float64()
    kwargs.setdefault("values", True)
    return (
        draw(csrs(r, m, dtype=dtype, **kwargs)),
        draw(csrs(m, c, dtype=dtype, **kwargs)),
    )


@st.composite
def sparse_matrices(draw, max_shape=(1000, 1000), density=None, format="csr"):
    """scipy.sparse matrices, for host-interop tests."""
    r = draw(dims(max_shape[0]))
    c = draw(dims(max_shape[1]))
    d = draw(fractions() if density is None else density)
    return sps.random(r, c, d, format=format)


def matrices(max_shape=(100, 100), dtype="f8"):
    """Dense numpy matrices."""
    shape = st.tuples(dims(max_shape[0]), dims(max_shape[1]))
    return nph.arrays(dtype, shape)


def csr_slow(divider: int = 2):
    """Settings for slow property tests: halved example count, no
    deadline, health checks off (layout builds have high variance)."""
    base = settings.default
    return settings(
        base,
        deadline=None,
        suppress_health_check=list(HealthCheck),
        max_examples=max(base.max_examples // divider, 1),
    )


def has_memory(req_gb: float = 32) -> bool:
    """Gate for tests needing ``req_gb`` GiB of host RAM."""
    total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total >= req_gb * 1024**3
