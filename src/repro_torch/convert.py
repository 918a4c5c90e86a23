"""Carries a built index across frameworks as plain numpy arrays.

:func:`index_from_numpy` turns the 17 ``DeviceIndexArrays`` fields of an
index — pulled to the host by whoever built it, the JAX package included
— into this package's :class:`~repro_torch.core.index.CPQxIndex` on a
torch device; :func:`index_to_numpy` is the inverse.  Both sides name the
fields alike, so ``{f: np.asarray(getattr(arrays, f)) for f in
arrays._fields}`` plus, for an iaCPQx index, its ``interests`` set is the
whole hand-over."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.capacity import BuildCaps, FlushCaps
from .core.index import CPQxIndex, DeviceIndexArrays, _pull_seq_ranges, resolve_device

FIELDS = DeviceIndexArrays._fields


def index_from_numpy(fields: Mapping[str, np.ndarray], k: int,
                     n_vertices: int, caps: BuildCaps | FlushCaps | None = None,
                     device=None, interests=None) -> CPQxIndex:
    """Device index from host arrays, on the CUDA card unless ``device``
    names another.  Every field is int32 except ``overflow`` (bool).
    ``interests`` is the interest set L_q of an iaCPQx index: its
    ``interests`` attribute, or the -1-padded rows ``index_to_numpy``
    stores under ``"interests"`` (read from ``fields`` when not given).
    None, and no such field, means a full CPQx.  Without it an iaCPQx
    index would be planned as a full one, and a sequence it does not hold
    would be looked up instead of split."""
    dev = resolve_device(device)
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing index fields: {missing}")
    tensors = {}
    for f in FIELDS:
        dtype = np.bool_ if f == "overflow" else np.int32
        tensors[f] = torch.from_numpy(np.array(fields[f], dtype=dtype)).to(dev)
    arrays = DeviceIndexArrays(**tensors)
    if interests is None:
        interests = fields.get("interests")
    if interests is not None:
        interests = frozenset(tuple(int(x) for x in s if int(x) >= 0)
                              for s in interests)
    return CPQxIndex(k=k, n_vertices=n_vertices, arrays=arrays,
                     seq_ranges=_pull_seq_ranges(arrays, k), caps=caps,
                     interests=interests)


def index_to_numpy(index: CPQxIndex) -> dict[str, np.ndarray]:
    """The index's 17 device arrays as host numpy arrays, by field name;
    an iaCPQx index adds its interest set under ``"interests"`` as sorted
    (n, k) int32 rows padded with -1."""
    out = {f: getattr(index.arrays, f).cpu().numpy() for f in FIELDS}
    if index.interests is not None:
        k = index.k
        out["interests"] = np.array(
            sorted(tuple(s) + (-1,) * (k - len(s)) for s in index.interests),
            np.int32).reshape(-1, k)
    return out
