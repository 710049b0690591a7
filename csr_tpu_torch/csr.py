"""
Compressed sparse row matrices on PyTorch (counterpart of
:mod:`csr_tpu.csr`).

The three data arrays (``rowptrs``, ``colinds``, ``values``) are torch
tensors on one explicit ``device``.  A matrix built from numpy arrays
also keeps them as ``_host``: the micro-block packing of the ``cuda``
kernel runs on the host, and reading the tensors back from the card
would cost a copy.

The value array is optional: a structure-only matrix has implicit
values of 1.0 (float32).

This slice ports the container, its conversions and SpMV in both
directions.  The other methods of the JAX class are ROADMAP Queue 1
items 5-7 and raise :class:`NotImplementedError` naming the item.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import structure
from .dtypes import COLIND_DTYPE, INT32_MAX, VALUE_DTYPE, ptr_dtype
from .kernels import get_kernel, releasing

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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to csr_tpu_torch yet (ROADMAP Queue 1 {item})"
    )


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

    __slots__ = ("nrows", "ncols", "rowptrs", "colinds", "_values", "_host",
                 "_mb_layout_cache", "_mb_layout_t_cache", "_shard_cache")

    def __init__(self, nrows, ncols, nnz, rps, cis, vs, _cast=True,
                 device=None):
        _require(0 <= nrows <= INT32_MAX and 0 <= ncols <= INT32_MAX and nnz >= 0,
                 f"bad shape {nrows}x{ncols} with {nnz} entries")
        self.nrows = int(nrows)
        self.ncols = int(ncols)

        tensors = [a for a in (rps, cis, vs) if isinstance(a, torch.Tensor)]
        if device is None:
            device = tensors[0].device if tensors else "cpu"
        device = torch.device(device)
        # keep the host arrays when the data arrived as numpy: packing for
        # the cuda kernel runs on the host
        if tensors:
            self._host = None
        else:
            self._host = (np.asarray(rps), np.asarray(cis),
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
        self._host = None
        if vs is None:
            self._values = None
            return
        vs = _as_tensor(vs, None, self.device)
        if vs.shape[0] < self.nnz:
            raise ValueError("value array too small")
        self._values = vs[: self.nnz]

    def host_arrays(self):
        """``(rowptrs, colinds, values)`` as numpy arrays: the kept host
        copies, or the tensors read back."""
        if self._host is not None:
            return self._host
        vs = self.values
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
            device: where the tensors live (default CPU).
        """
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
            device: where the tensors live (default CPU).
        """
        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

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
            rpdtype = torch.from_numpy(np.zeros(0, rpdtype)).dtype
            if nnz > torch.iinfo(rpdtype).max:
                raise ValueError(f"rpdtype {rpdtype} cannot address {nnz} entries")
            csr.rowptrs = csr.rowptrs.to(rpdtype)
        return csr

    @classmethod
    def from_scipy(cls, mat, copy=True, *, device=None):
        """A matrix from a scipy sparse matrix.  The data is copied to
        ``device``; ``copy`` is accepted for API compatibility."""
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

    # -- implicit-value helpers -------------------------------------------

    def _required_values(self):
        """Value array, or implicit ones for structure-only matrices."""
        vs = self.values
        if vs is None:
            return torch.ones(self.nnz, dtype=VALUE_DTYPE, device=self.device)
        return vs

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
        if self._host is not None:
            out._host = structure.subset_rows_arrays(*self._host, begin, end)[:3]
        return out

    def rowinds(self):
        """Row index of every stored entry (the COO row vector)."""
        return structure.row_ids_for(self)

    # -- multiplication ----------------------------------------------------

    def _operand(self, v, n):
        v = _as_tensor(v, None, self.device)
        if v.shape != (n,):
            raise ValueError(f"operand of shape {tuple(v.shape)}, expected ({n},)")
        return v

    def mult_vec(self, v):
        """
        SpMV: :math:`A\\vec{x}` on the active kernel.

        Args:
            v(array-like): a vector of length ``ncols``; array-likes are
                placed on the matrix's device.

        Returns:
            torch.Tensor: length ``nrows``, on the matrix's device.
        """
        v = self._operand(v, self.ncols)
        K = get_kernel()
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                return K.mult_vec(h, v)
        svs = []
        for s in self._shard_rows(K.max_nnz):
            with releasing(K.to_handle(s), K) as h:
                svs.append(K.mult_vec(h, v))
        return torch.cat(svs)

    def mult_vec_t(self, v):
        """
        Transpose SpMV: :math:`A^{T}\\vec{v}` on the active kernel.

        Args:
            v(array-like): a vector of length ``nrows``.

        Returns:
            torch.Tensor: length ``ncols``, on the matrix's device.
        """
        v = self._operand(v, self.nrows)
        K = get_kernel()
        if self.nnz <= K.max_nnz:
            with releasing(K.to_handle(self), K) as h:
                return K.mult_vec_t(h, v)
        # row shards contribute partial sums over the whole column space
        out = None
        off = 0
        for s in self._shard_rows(K.max_nnz):
            with releasing(K.to_handle(s), K) as h:
                part = K.mult_vec_t(h, v[off : off + s.nrows])
            out = part if out is None else out + part
            off += s.nrows
        return out

    def multiply(self, other, transpose=False):
        _not_ported("CSR.multiply (SpGEMM)", "item 6")

    def mult_dense(self, b):
        _not_ported("CSR.mult_dense (SpMM)", "item 5")

    def transpose(self, include_values=True):
        _not_ported("CSR.transpose", "item 7")

    def sort_rows(self):
        _not_ported("CSR.sort_rows", "item 7")

    def normalize_rows(self, normalization):
        _not_ported("CSR.normalize_rows", "item 7")

    # -- capacity sharding -------------------------------------------------

    def _shard_rows(self, tgt_nnz):
        """Shard by rows so each shard has at most ``tgt_nnz`` stored
        entries.  The shard list is cached on the matrix (keyed on the
        identity of its three tensors and the target), so a second call
        reuses each shard's cached layout."""
        assert tgt_nnz > 0
        cached = getattr(self, "_shard_cache", None)
        if (
            cached is not None
            and cached[0] is self.rowptrs
            and cached[1] is self.colinds
            and cached[2] is self._values
            and cached[3] == tgt_nnz
        ):
            return cached[4]

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
        self._shard_cache = (
            self.rowptrs, self.colinds, self._values, tgt_nnz, shards
        )
        return shards

    @classmethod
    def _assemble_shards(cls, shards):
        """Reassemble a matrix from row shards."""
        offs = np.cumsum([0] + [s.nnz for s in shards])
        nnz = int(offs[-1])
        rps = torch.cat(
            [s.rowptrs[:-1].to(torch.int64) + int(o) for s, o in zip(shards, offs)]
            + [torch.tensor([nnz], device=shards[0].device)]
        )
        cis = torch.cat([s.colinds for s in shards])
        vs = None
        if all(s.values is not None for s in shards):
            vs = torch.cat([s.values for s in shards])
        return cls(sum(s.nrows for s in shards), shards[0].ncols, nnz, rps,
                   cis, vs)

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
