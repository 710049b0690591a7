"""
Checkpoint / serialization (counterpart of
:mod:`csr_tpu.utils.serialization`).

The npz field names are the JAX package's, so a file written by
``csr_tpu.utils.serialization.save_npz`` loads here and the reverse.
:func:`from_arrays` builds a matrix from numpy arrays, for instance those
of a ``csr_tpu.CSR``; :func:`parallel_from_arrays` does the same for the
partitioned forms of :mod:`csr_tpu_torch.parallel`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from csr_tpu_torch.csr import CSR


def from_arrays(nrows, ncols, rowptrs, colinds, values, device=None) -> CSR:
    """A matrix on ``device`` from numpy CSR arrays (``values`` may be
    None for a structure-only matrix)."""
    return CSR(nrows, ncols, len(colinds), np.asarray(rowptrs),
               np.asarray(colinds), None if values is None else np.asarray(values),
               device=device)


def parallel_from_arrays(cls, fields: dict):
    """A partitioned form ``cls`` (``DistCSR``, ``RingCSR``,
    ``DistMicroBlock``, ``DistMicroBlockT`` or ``RingMicroBlock`` of
    :mod:`csr_tpu_torch.parallel`) from the same-named fields of its
    ``csr_tpu.parallel`` counterpart, given as numpy arrays and numbers:
    the stacked arrays become host tensors (``.shard(mesh)`` places
    them), the per-shard offsets stay numpy, and what only the port holds
    is derived from them."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            continue
        v = fields[f.name]
        if f.name in cls.TENSORS:
            kw[f.name] = torch.from_numpy(np.require(v, requirements="CW"))
        elif np.ndim(v):
            kw[f.name] = np.asarray(v)
        else:
            kw[f.name] = int(v)
    return cls(**kw)


def to_state_dict(csr: CSR) -> dict:
    """Flat tensor mapping, for ``torch.save`` or a checkpointer."""
    d = {
        "rowptrs": csr.rowptrs,
        "colinds": csr.colinds,
        "shape": np.asarray([csr.nrows, csr.ncols], np.int64),
    }
    if csr.values is not None:
        d["values"] = csr.values
    return d


def from_state_dict(d, device=None) -> CSR:
    nrows, ncols = (int(x) for x in np.asarray(d["shape"]))
    cis = d["colinds"]
    return CSR(nrows, ncols, int(cis.shape[0]), d["rowptrs"], cis,
               d.get("values"), device=device)


def save_npz(path, csr: CSR, compressed: bool = True):
    """Save to an ``.npz`` archive."""
    rps, cis, vs = csr.host_arrays()
    arrays = {
        "rowptrs": rps,
        "colinds": cis,
        "shape": np.asarray([csr.nrows, csr.ncols], np.int64),
        "has_values": np.asarray(vs is not None),
    }
    if vs is not None:
        arrays["values"] = vs
    (np.savez_compressed if compressed else np.savez)(path, **arrays)


def load_npz(path, device=None) -> CSR:
    """Load a matrix saved with :func:`save_npz` (of either package)."""
    with np.load(path) as d:
        nrows, ncols = (int(x) for x in d["shape"])
        values = d["values"] if bool(d["has_values"]) else None
        return from_arrays(nrows, ncols, d["rowptrs"], d["colinds"], values,
                           device)
