"""
Compressed sparse row matrices on PyTorch (counterpart of
:mod:`csr_tpu.csr`).

The three data arrays (``rowptrs``, ``colinds``, ``values``) are torch
tensors on one ``device``.  Tensor inputs keep their device; a matrix
built from numpy or scipy data with no ``device`` named lies on
:func:`csr_tpu_torch.kernels.default_device`: the card when there is
one, the CPU only where there is none.  A matrix built from numpy arrays
also keeps them as its host copies: the micro-block packing of the ``cuda``
kernel runs on the host, and reading the tensors back from the card
would cost a copy.  On the CPU the arrays are copied first (one pass
over them), as the JAX package copies them to its device, so the
tensors never alias the caller's arrays; on the card the kept arrays are
the caller's, which the caller must then leave as they are: the tensors
on the card would not see an edit of them, and the host packing would.

The value array is optional: a structure-only matrix has implicit
values of 1.0 (float32).

The methods that work "in place" (``sort_rows``, ``normalize_rows``,
``fill_values``, ``drop_values``, ``_filter_zeros``) bind new tensors;
they never write into the tensors they held.
What a matrix keeps (the ``cuda`` kernel's layouts, share edges and
panels, the row shards, the host copies, the product plans of
:mod:`csr_tpu_torch._plan`) is one set, :mod:`csr_tpu_torch._forms`,
stamped with the identity of the three tensors and their version
counters (:meth:`CSR._versions`), so a rebinding or an in-place edit of
a tensor (``values.mul_(2)``) drops the whole set at the next look-up.

A CSR is a ``torch.utils._pytree`` node, as the JAX class is a pytree:
``torch.func.vmap`` and ``torch.func.grad`` take and return it.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch
import torch.utils._pytree as _pytree

from . import _forms, _plan, _rows, structure
from .dtypes import COLIND_DTYPE, INT32_MAX, VALUE_DTYPE, ptr_dtype
from .kernels import default_device, get_kernel, releasing
from .tracing import count, spanned

_log = logging.getLogger(__name__)

__all__ = ["CSR"]


def _as_tensor(x, dtype, device):
    """``x`` (numpy, array-like or tensor) as a tensor on ``device``,
    converted to ``dtype`` unless it is None."""
    if not isinstance(x, torch.Tensor):
        # a writable, contiguous array: torch refuses to alias read-only
        # memory without a warning
        x = torch.as_tensor(np.require(np.asarray(x), requirements="CW"))
    return x.to(device=device, dtype=dtype)


def _require(cond, msg: str):
    if not cond:
        raise ValueError(msg)


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype (or its name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


class CSR:
    """
    Compressed sparse row matrix with torch tensors on one device.

    Attributes:
        nrows(int): the number of rows.
        ncols(int): the number of columns.
        nnz(int): the number of stored entries.
        rowptrs(torch.Tensor): the row pointers, shape ``(nrows + 1,)``.
        colinds(torch.Tensor): the column indices, shape ``(nnz,)``.
        values(torch.Tensor or None): the values, shape ``(nnz,)``.
        device(torch.device): where the tensors live.
    """

    __slots__ = ("nrows", "ncols", "rowptrs", "colinds", "_values", "_forms")

    def __init__(self, nrows, ncols, nnz, rps, cis, vs, _cast=True,
                 device=None):
        _require(0 <= nrows <= INT32_MAX and 0 <= ncols <= INT32_MAX and nnz >= 0,
                 f"bad shape {nrows}x{ncols} with {nnz} entries")
        self.nrows = int(nrows)
        self.ncols = int(ncols)

        tensors = [a for a in (rps, cis, vs) if isinstance(a, torch.Tensor)]
        if device is None:
            device = tensors[0].device if tensors else default_device()
        device = torch.device(device)
        if device.type == "cpu":  # tensors made of them would alias them
            rps, cis, vs = (a if a is None or isinstance(a, torch.Tensor)
                            else np.array(a) for a in (rps, cis, vs))
        # keep the host arrays when the data arrived as numpy: packing for
        # the cuda kernel runs on the host
        host = None if tensors else (np.asarray(rps), np.asarray(cis),
                                     None if vs is None else np.asarray(vs))

        if _cast:
            cis = _as_tensor(cis, COLIND_DTYPE, device)
            rps = _as_tensor(rps, ptr_dtype(nnz), device)
        else:
            cis = _as_tensor(cis, None, device)
            rps = _as_tensor(rps, None, device)
        vs = None if vs is None else _as_tensor(vs, None, device)

        _require(rps.shape == (self.nrows + 1,) and cis.shape == (nnz,),
                 f"rowptrs {tuple(rps.shape)} and colinds {tuple(cis.shape)}"
                 f" do not fit {self.nrows} rows and {nnz} entries")
        self.rowptrs = rps
        self.colinds = cis
        self._values = vs
        self._forms = None
        if host is not None:
            _forms.forms(self)["host"] = host

    # -- shape / data properties -------------------------------------------

    @property
    def nnz(self) -> int:
        return int(self.colinds.shape[0])

    @property
    def device(self) -> torch.device:
        return self.colinds.device

    @property
    def values(self):
        return self._values

    @values.setter
    def values(self, vs):
        if vs is None:  # no identity for the stamp to tell from an earlier None
            self._values = None
            self._forms = None
            return
        vs = _as_tensor(vs, None, self.device)
        if vs.shape[0] < self.nnz:
            raise ValueError("value array too small")
        self._values = vs[: self.nnz]

    def _versions(self) -> tuple:
        """The version counters of the three tensors (None for absent
        values, -1 for an inference tensor, which keeps none).  An
        in-place edit of a tensor moves its counter, so a form made from
        the tensors is stale once these differ from those it was made at."""
        rp, ci, vs = self.rowptrs, self.colinds, self._values
        try:
            return (rp._version, ci._version, None if vs is None else vs._version)
        except RuntimeError:  # an inference tensor keeps no version counter
            return (-1 if rp.is_inference() else rp._version,
                    -1 if ci.is_inference() else ci._version,
                    None if vs is None else -1 if vs.is_inference() else vs._version)

    def host_arrays(self):
        """``(rowptrs, colinds, values)`` as numpy arrays: the kept host
        copies, or the tensors read back."""
        host = _forms.forms(self).get("host")
        if host is not None:
            return host
        vs = self.values
        count("host_reads", 2 if vs is None else 3)
        return (self.rowptrs.cpu().numpy(), self.colinds.cpu().numpy(),
                None if vs is None else vs.cpu().numpy())

    # -- constructors ------------------------------------------------------

    @classmethod
    def empty(cls, nrows, ncols, row_nnzs=None, values=True, *, device=None):
        """A zero-filled matrix.

        Args:
            nrows(int): the number of rows.
            ncols(int): the number of columns.
            row_nnzs(array-like): stored entries per row, or None for an
                empty matrix.
            values(bool or torch.dtype): whether it has values, or their
                dtype (default float32).
            device: where the tensors live (default
                :func:`~csr_tpu_torch.kernels.default_device`).
        """
        device = default_device() if device is None else device
        rps = np.zeros(nrows + 1, np.int64)
        if row_nnzs is not None:
            row_nnzs = np.asarray(row_nnzs)
            _require(len(row_nnzs) == nrows, "row_nnzs must have nrows entries")
            np.cumsum(row_nnzs, dtype=np.int64, out=rps[1:])
        nnz = int(rps[-1])
        vs = None
        if values:
            vs = torch.zeros(nnz, dtype=VALUE_DTYPE if values is True else values)
        return cls(nrows, ncols, nnz, torch.from_numpy(rps),
                   torch.zeros(nnz, dtype=COLIND_DTYPE), vs, device=device)

    @classmethod
    @spanned("csr.construct.from_coo")
    def from_coo(cls, rows, cols, vals, shape=None, *, rpdtype=None,
                 device=None):
        """
        A matrix from COO data, converted on the host.  Entries keep their
        input order within each row.

        Args:
            rows(array-like): the row indices.
            cols(array-like): the column indices.
            vals(array-like): the values; can be ``None``.
            shape(tuple): the shape, or ``None`` to infer it.
            rpdtype(numpy.dtype): row-pointer dtype, or ``None`` for the
                automatic policy (int32, widened past INT32_MAX entries).
            device: where the tensors live (default
                :func:`~csr_tpu_torch.kernels.default_device`).
        """
        def host(a):
            if isinstance(a, torch.Tensor):
                count("host_reads")
                return a.cpu().numpy()
            return np.asarray(a)

        rows, cols = host(rows), host(cols)
        vals = None if vals is None else host(vals)
        nnz = len(rows)
        _require(len(cols) == nnz and (vals is None or len(vals) == nnz),
                 "rows, cols and vals must have one length")
        if nnz:
            _require(rows.min() >= 0 and cols.min() >= 0, "negative index")
            rmax, cmax = int(rows.max()), int(cols.max())
        else:
            rmax = cmax = -1
        if shape is None:
            nrows, ncols = rmax + 1, cmax + 1
        else:
            nrows, ncols = shape
            _require(rmax < max(nrows, 1) and cmax < max(ncols, 1),
                     f"index out of range of shape {shape}")

        rps, cis, vs = structure.from_coo(nrows, rows, cols, vals)
        csr = cls(nrows, ncols, nnz, rps, cis, vs, device=device)
        if rpdtype is not None:
            rpdtype = _torch_dtype(rpdtype)
            if nnz > torch.iinfo(rpdtype).max:
                raise ValueError(f"rpdtype {rpdtype} cannot address {nnz} entries")
            host = csr.host_arrays()  # the same entries in a new dtype
            csr.rowptrs = csr.rowptrs.to(rpdtype)
            _forms.forms(csr)["host"] = host
        return csr

    @classmethod
    def from_scipy(cls, mat, copy=True, *, device=None):
        """A matrix from a scipy sparse matrix.  The data is copied to
        ``device`` (default :func:`~csr_tpu_torch.kernels.default_device`);
        ``copy`` is accepted for API compatibility."""
        import scipy.sparse as sps

        if not sps.issparse(mat):
            raise TypeError("not a scipy sparse matrix")
        if mat.format != "csr":
            mat = mat.tocsr(copy=copy)
        return cls(mat.shape[0], mat.shape[1], mat.nnz, mat.indptr,
                   mat.indices, mat.data, device=device)

    def to_scipy(self):
        """The matrix as a :class:`scipy.sparse.csr_matrix` on the host."""
        import scipy.sparse as sps

        rps, cis, vs = self.host_arrays()
        if vs is None:
            vs = np.full(self.nnz, 1.0)
        return sps.csr_matrix((vs, cis, rps), shape=(self.nrows, self.ncols))

    @classmethod
    def from_torch_sparse(cls, t):
        """A matrix from a 2-D torch sparse CSR or COO tensor, on its
        device (the counterpart of the JAX class's ``from_bcoo``).  A CSR
        tensor's arrays are taken as they are; a COO tensor is converted
        by torch first, which sums repeated coordinates."""
        _require(t.layout in (torch.sparse_csr, torch.sparse_coo)
                 and t.ndim == 2 and t.dense_dim() == 0,
                 f"expected a 2-D sparse CSR or COO tensor without dense"
                 f" dimensions, got {t.layout} with shape {tuple(t.shape)}")
        if t.layout == torch.sparse_coo:
            t = t.to_sparse_csr()
        nrows, ncols = t.shape
        cis = t.col_indices()
        return cls(nrows, ncols, cis.shape[0], t.crow_indices(), cis, t.values())

    def to_torch_sparse(self, layout=torch.sparse_csr):
        """The matrix as a torch sparse tensor on its device: CSR (its own
        arrays, row pointers and column indices in one index dtype) or
        COO (``layout=torch.sparse_coo``), structure-only matrices with
        ones.  The COO form is not coalesced: a matrix may hold unsorted
        rows and repeated coordinates, and torch sums those when it
        coalesces."""
        vs = self._required_values()
        shape = (self.nrows, self.ncols)
        if layout == torch.sparse_coo:
            idx = torch.stack([self.rowinds().to(torch.int64),
                               self.colinds.to(torch.int64)])
            return torch.sparse_coo_tensor(idx, vs, shape, is_coalesced=False,
                                           check_invariants=False)
        _require(layout == torch.sparse_csr, f"layout {layout}: expected"
                 " torch.sparse_csr or torch.sparse_coo")
        idx = torch.promote_types(self.rowptrs.dtype, self.colinds.dtype)
        return torch.sparse_csr_tensor(self.rowptrs.to(idx),
                                       self.colinds.to(idx), vs, shape,
                                       check_invariants=False)

    # -- implicit-value helpers -------------------------------------------

    def _required_values(self):
        """Value array, or implicit ones for structure-only matrices."""
        vs = self.values
        if vs is None:
            return torch.ones(self.nnz, dtype=VALUE_DTYPE, device=self.device)
        return vs

    def _e_value(self, i):
        """Value of entry ``i``, 1.0 for a structure-only matrix."""
        vs = self.values
        return 1.0 if vs is None else vs[i]

    def _normalize(self, val_dtype=np.float64, ptr_dtype=None):
        """A matrix of this one's structure in predictable dtypes: values
        in ``val_dtype`` (ones for a structure-only matrix), none if it is
        False, this matrix's if it is None; row pointers in ``ptr_dtype``
        if given.  f64 stays f64."""
        rps = self.rowptrs
        if ptr_dtype:
            ptr_dtype = _torch_dtype(ptr_dtype)
            if self.nnz > torch.iinfo(ptr_dtype).max:
                raise ValueError(f"type {ptr_dtype} cannot address {self.nnz}"
                                 " entries")
            rps = rps.to(ptr_dtype)
        if val_dtype:
            vs = self._required_values().to(_torch_dtype(val_dtype))
        elif val_dtype is False:
            vs = None
        else:
            vs = self.values
        return CSR(self.nrows, self.ncols, self.nnz, rps, self.colinds, vs,
                   _cast=False)

    def copy(self, include_values=True, *, copy_structure=True):
        """A copy of this matrix, sharing the structure tensors unless
        ``copy_structure``."""
        vs = self.values if include_values else None
        rps, cis = self.rowptrs, self.colinds
        if copy_structure:
            rps, cis = rps.clone(), cis.clone()
            vs = None if vs is None else vs.clone()
        return CSR(self.nrows, self.ncols, self.nnz, rps, cis, vs, _cast=False)

    # -- rows ----------------------------------------------------------------

    def subset_rows(self, begin, end):
        """Rows ``[begin, end)`` as a new matrix sharing this one's storage
        (and its host copies, where it has them)."""
        rps, cis, vs, nnz = structure.subset_rows_arrays(
            self.rowptrs, self.colinds, self.values, begin, end
        )
        out = CSR(end - begin, self.ncols, nnz, rps, cis, vs, _cast=False)
        host = _forms.forms(self).get("host")
        if host is not None:
            _forms.forms(out)["host"] = structure.subset_rows_arrays(
                *host, begin, end)[:3]
        return out

    def pick_rows(self, rows, *, include_values=True):
        """Rows ``rows`` (repeats allowed) as a new matrix."""
        rows = _as_tensor(rows, torch.int64, self.device)
        inc = include_values and self.values is not None
        rps, cis, vs, nnz = structure.pick_rows_arrays(self, rows, inc)
        return CSR(len(rows), self.ncols, nnz, rps, cis, vs, _cast=False)

    def rowinds(self):
        """Row index of every stored entry (the COO row vector)."""
        return structure.row_ids_for(self)

    def row(self, row):
        """Row ``row`` (an int) or rows (a sequence) as dense tensors;
        ones at the stored positions of a structure-only matrix."""
        return _rows.row_array(self, row)

    def row_mask(self, row):
        """Boolean mask(s) of the stored columns of one or more rows."""
        return _rows.row_mask(self, row)

    def row_extent(self, row):
        """``(start, end)`` of a row in the data arrays."""
        return _rows.extent(self, row)

    def row_cs(self, row):
        """Column indices of a row's stored entries."""
        return _rows.cs(self, row)

    def row_vs(self, row):
        """Stored values of a row; ones if structure-only."""
        return _rows.vs(self, row)

    def row_nnzs(self):
        """Number of stored entries of each row."""
        return torch.diff(self.rowptrs)

    # -- structure ops -----------------------------------------------------

    def sort_rows(self):
        """Sort each row's entries by column, **in place** (new tensors
        are bound; see the module docstring)."""
        cis, vs = structure.sort_rows_arrays(self.rowptrs, self.colinds,
                                             self.values, self.nrows)
        self.colinds = cis
        self._values = vs

    def transpose(self, include_values=True):
        """The transpose, on this matrix's device; within each of its rows
        the entries come in increasing column order."""
        vs = self.values if include_values else None
        rps, cis, t_vs = structure.transpose_arrays(
            self.rowptrs, self.colinds, vs, self.nrows, self.ncols)
        return CSR(self.ncols, self.nrows, self.nnz, rps, cis, t_vs, _cast=False)

    def transpose_structure(self):
        """The transpose without values."""
        return self.transpose(False)

    def filter_nnzs(self, filt):
        """A new matrix of the entries where the boolean mask ``filt``
        (one element an entry) is True."""
        filt = _as_tensor(filt, torch.bool, self.device)
        if filt.shape != (self.nnz,):
            raise ValueError(f"filter has shape {tuple(filt.shape)}, expected"
                             f" ({self.nnz},)")
        rps, cis, vs, nnz = structure.filter_nnzs_arrays(self, filt)
        return CSR(self.nrows, self.ncols, nnz, rps, cis, vs, _cast=False)

    # -- transforms --------------------------------------------------------

    def normalize_rows(self, normalization):
        """Normalise each row's values **in place** (new values are
        bound) and return the per-row statistic.

        Args:
            normalization(str): ``'center'`` (subtract the row mean, which
                is returned) or ``'unit'`` (scale to unit Euclidean norm,
                which is returned).
        """
        from . import transform

        if normalization == "center":
            fn = transform.center_rows
        elif normalization == "unit":
            fn = transform.unit_rows
        else:
            raise ValueError("unknown normalization: " + str(normalization))
        if self.values is None:
            raise ValueError("cannot normalize a structure-only matrix")
        vs, stats = fn(self)
        self._values = vs
        return stats

    def drop_values(self):
        """Remove the value array **in place** (deprecated)."""
        warnings.warn("drop_values is deprecated", DeprecationWarning)
        self.values = None

    def fill_values(self, value):
        """Set every stored value to ``value`` **in place** (a new tensor
        is bound), giving a structure-only matrix float32 values."""
        vs = self.values
        if vs is None:
            vs = torch.empty(self.nnz, dtype=VALUE_DTYPE, device=self.device)
        self._values = torch.full_like(vs, value)

    # -- multiplication ----------------------------------------------------

    def _operand(self, v, n):
        v = _as_tensor(v, None, self.device)
        if v.shape != (n,):
            raise ValueError(f"operand of shape {tuple(v.shape)}, expected ({n},)")
        return v

    @spanned("csr.api.mult_vec")
    def mult_vec(self, v):
        """
        SpMV: :math:`A\\vec{x}` on the active kernel.

        Args:
            v(array-like): a vector of length ``ncols``; array-likes are
                placed on the matrix's device.

        Returns:
            torch.Tensor: length ``nrows``, on the matrix's device.
        """
        K = get_kernel()
        y = _plan.run(self, K, ("plan", "mult_vec"), v)
        if y is not None:
            return y
        v = self._operand(v, self.ncols)
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                y = K.mult_vec(h, v)
            _plan.keep(self, K, ("plan", "mult_vec"), h)
            return y
        svs = []
        for s in self._shard_rows(K.max_nnz):
            with releasing(K.to_handle(s), K) as h:
                svs.append(K.mult_vec(h, v))
        return torch.cat(svs)

    @spanned("csr.api.mult_vec_t")
    def mult_vec_t(self, v):
        """
        Transpose SpMV: :math:`A^{T}\\vec{v}` on the active kernel.

        Args:
            v(array-like): a vector of length ``nrows``.

        Returns:
            torch.Tensor: length ``ncols``, on the matrix's device.
        """
        K = get_kernel()
        y = _plan.run(self, K, ("plan", "mult_vec_t"), v)
        if y is not None:
            return y
        v = self._operand(v, self.nrows)
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                y = K.mult_vec_t(h, v)
            _plan.keep(self, K, ("plan", "mult_vec_t"), h)
            return y
        # row shards contribute partial sums over the whole column space
        out = None
        off = 0
        for s in self._shard_rows(K.max_nnz):
            with releasing(K.to_handle(s), K) as h:
                part = K.mult_vec_t(h, v[off : off + s.nrows])
            out = part if out is None else out + part
            off += s.nrows
        return out

    @spanned("csr.api.multiply")
    def multiply(self, other, transpose=False):
        """
        SpGEMM: :math:`AB` (or :math:`AB^{T}`) on the active kernel.

        Args:
            other(CSR): the other matrix, on this matrix's device.
            transpose(bool): if ``True``, compute :math:`AB^{T}`.

        Returns:
            CSR: the product, with explicit zeros filtered out, on this
            matrix's device.
        """
        inner = other.ncols if transpose else other.nrows
        _require(self.ncols == inner,
                 f"cannot multiply {self.nrows}x{self.ncols} by "
                 f"{other.nrows}x{other.ncols}{'^T' if transpose else ''}")
        _require(other.device == self.device,
                 f"operands on {self.device} and {other.device}")
        K = get_kernel()

        def mul(a, b_h):
            with releasing(K.to_handle(a), K) as a_h:
                c_h = K.mult_abt(a_h, b_h) if transpose else K.mult_ab(a_h, b_h)
                with releasing(c_h, K):
                    c = K.from_handle(c_h)
            if c.device != self.device:  # the scipy oracle computes on the host
                c = CSR(c.nrows, c.ncols, c.nnz, *c.host_arrays(),
                        device=self.device)
            c._filter_zeros()
            return c

        with releasing(K.to_handle(other), K) as b_h:
            if self.nnz <= K.max_nnz:
                return mul(self, b_h)
            parts = [mul(s, b_h) for s in self._shard_rows(K.max_nnz)]
        return CSR._assemble_shards(parts)

    @spanned("csr.api.mult_dense")
    def mult_dense(self, b):
        """
        SpMM: :math:`AB` for a dense ``B`` on the active kernel.

        Args:
            b(array-like): a matrix of shape ``(ncols, n)``; array-likes
                are placed on the matrix's device.

        Returns:
            torch.Tensor: shape ``(nrows, n)``, on the matrix's device.
        """
        K = get_kernel()
        c = _plan.run(self, K, ("plan", "mult_dense"), b)
        if c is not None:
            return c
        b = _as_tensor(b, None, self.device)
        if b.ndim != 2 or b.shape[0] != self.ncols:
            raise ValueError(f"operand of shape {tuple(b.shape)}, expected"
                             f" ({self.ncols}, n)")
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                c = K.mult_dense(h, b)
            _plan.keep(self, K, ("plan", "mult_dense"), h)
            return c
        outs = []
        for s in self._shard_rows(K.max_nnz):
            with releasing(K.to_handle(s), K) as h:
                outs.append(K.mult_dense(h, b))
        return torch.cat(outs)

    def _filter_zeros(self):
        """Drop explicitly stored zero values, in place."""
        if self.values is None:
            return
        rps, cis, vs, _ = structure.filter_nnzs_arrays(self, self.values != 0)
        self.rowptrs = rps
        self.colinds = cis
        self._values = vs

    # -- capacity sharding -------------------------------------------------

    def _shard_rows(self, tgt_nnz):
        """Shard by rows so each shard has at most ``tgt_nnz`` stored
        entries.  The shard list is kept with the matrix's forms (key
        ``("shards", tgt_nnz)``), so a second call reuses each shard's
        cached layout and an in-place edit of a tensor drops it."""
        assert tgt_nnz > 0
        kept = _forms.forms(self)
        shards = kept.get(("shards", tgt_nnz))
        if shards is not None:
            return shards

        rowptrs_host = self.host_arrays()[0]
        rest = self
        rest_off = 0
        shards = []
        while rest.nnz > tgt_nnz:
            rp = rowptrs_host[rest_off:] - rowptrs_host[rest_off]
            split = int(np.searchsorted(rp[: rest.nrows + 1], tgt_nnz, side="right")) - 1
            if rp[split] > tgt_nnz:
                split -= 1
            if split < 1:
                raise ValueError("row too large to fit in target matrix size")
            _log.debug("splitting %s at %d (rp@s: %d)", rest, split, rp[split])
            shards.append(rest.subset_rows(0, split))
            rest = rest.subset_rows(split, rest.nrows)
            rest_off += split
        shards.append(rest)
        kept[("shards", tgt_nnz)] = shards
        return shards

    @classmethod
    def _assemble_shards(cls, shards):
        """Reassemble a matrix from row shards; the first shard decides
        whether it has values (see
        :func:`~csr_tpu_torch.structure.assemble_shards_arrays`)."""
        nrows, ncols, nnz, rps, cis, vs = structure.assemble_shards_arrays(shards)
        return cls(nrows, ncols, nnz, rps, cis, vs, _cast=False)

    # -- dunder ------------------------------------------------------------

    def __str__(self):
        return "<CSR {}x{} ({} nnz)>".format(self.nrows, self.ncols, self.nnz)

    def __repr__(self):
        vs = self.values
        return (
            f"<CSR {self.nrows}x{self.ncols} ({self.nnz} nnz) on {self.device} {{\n"
            f"  rowptrs={self.rowptrs}\n  colinds={self.colinds}\n"
            f"  values={vs}\n  dtype={None if vs is None else vs.dtype}\n}}>"
        )

    def __reduce__(self):
        # pickle through host arrays, restoring onto the same device
        rps, cis, vs = self.host_arrays()
        return (CSR, (self.nrows, self.ncols, self.nnz, rps, cis, vs, True,
                      str(self.device)))


# -- pytree registration -------------------------------------------------
# The counterpart of the JAX package's pytree registration: it makes a CSR
# an argument and a result of the torch.func transforms (vmap, grad).
# torch's pytree takes None for a leaf, so a structure-only matrix
# flattens to its two array leaves and the leaf count says whether it has
# values.


def _csr_flatten(c: CSR):
    leaves = [c.rowptrs, c.colinds]
    if c._values is not None:
        leaves.append(c._values)
    return leaves, (c.nrows, c.ncols)


def _csr_unflatten(leaves, context) -> CSR:
    """A CSR of the leaves, with no kept form (the leaves may be other
    tensors than the ones the forms were made from)."""
    leaves = list(leaves)
    obj = object.__new__(CSR)
    obj.nrows, obj.ncols = context
    obj.rowptrs, obj.colinds = leaves[:2]
    obj._values = leaves[2] if len(leaves) == 3 else None
    obj._forms = None
    return obj


_pytree.register_pytree_node(
    CSR, _csr_flatten, _csr_unflatten,
    serialized_type_name="csr_tpu_torch.csr.CSR")
