"""Carries a built index across frameworks as plain numpy arrays.

:func:`index_from_numpy` turns the 17 ``DeviceIndexArrays`` fields of an
index — pulled to the host by whoever built it, the JAX package included
— into this package's :class:`~repro_torch.core.index.CPQxIndex` on a
torch device; :func:`index_to_numpy` is the inverse.  Both sides name the
fields alike, so ``{f: np.asarray(getattr(arrays, f)) for f in
arrays._fields}`` is the whole hand-over."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.capacity import BuildCaps
from .core.index import CPQxIndex, DeviceIndexArrays, _pull_seq_ranges, resolve_device

FIELDS = DeviceIndexArrays._fields


def index_from_numpy(fields: Mapping[str, np.ndarray], k: int,
                     n_vertices: int, caps: BuildCaps | None = None,
                     device=None) -> CPQxIndex:
    """Device index from host arrays, on the CUDA card unless ``device``
    names another.  Every field is int32 except ``overflow`` (bool)."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing index fields: {missing}")
    tensors = {}
    for f in FIELDS:
        dtype = np.bool_ if f == "overflow" else np.int32
        tensors[f] = torch.from_numpy(np.array(fields[f], dtype=dtype)).to(dev)
    arrays = DeviceIndexArrays(**tensors)
    return CPQxIndex(k=k, n_vertices=n_vertices, arrays=arrays,
                     seq_ranges=_pull_seq_ranges(arrays, k), caps=caps)


def index_to_numpy(index: CPQxIndex) -> dict[str, np.ndarray]:
    """The index's 17 device arrays as host numpy arrays, by field name."""
    return {f: getattr(index.arrays, f).cpu().numpy() for f in FIELDS}
