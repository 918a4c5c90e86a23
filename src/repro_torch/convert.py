"""Carries a built index across frameworks as plain numpy arrays.

:func:`index_from_numpy` turns the 17 ``DeviceIndexArrays`` fields of an
index — pulled to the host by whoever built it, the JAX package included
— into this package's :class:`~repro_torch.core.index.CPQxIndex` on a
torch device; :func:`index_to_numpy` is the inverse.  Both sides name the
fields alike, so ``{f: np.asarray(getattr(arrays, f)) for f in
arrays._fields}`` plus, for an iaCPQx index, its ``interests`` set is the
whole hand-over.

:func:`gnn_params_from_numpy` and :func:`gnn_params_to_numpy` do the same
for a GNN's parameters: the reference's tree (nested dicts, each layer
leaf stacked on a leading ``n_layers`` axis) against the port's
``models.gnn.Params`` module (one ``nn.ModuleList`` entry a layer)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

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


def gnn_params_from_numpy(cfg, tree: Mapping, device=None):
    """The port's parameters of ``cfg`` (a ``models.gnn.GNNConfig``) from
    the reference's tree of host arrays, on the CUDA card unless
    ``device`` names another.  Leaves keep their dtype and values."""
    from .models.gnn import Params

    dev = resolve_device(device)

    def build(node):
        if isinstance(node, Mapping):
            return Params(**{k: build(node[k]) for k in node})
        return torch.from_numpy(np.array(node)).to(dev)

    def layer(node, i):
        if isinstance(node, Mapping):
            return {k: layer(node[k], i) for k in node}
        if np.shape(node)[0] != cfg.n_layers:
            raise ValueError(f"a layer leaf of {np.shape(node)} is not "
                             f"stacked over {cfg.n_layers} layers")
        return np.asarray(node)[i]

    top = {k: build(v) for k, v in tree.items() if k != "layers"}
    layers = nn.ModuleList(build(layer(tree["layers"], i))
                           for i in range(cfg.n_layers))
    return Params(**top, layers=layers)


def gnn_params_to_numpy(cfg, params) -> dict:
    """The reference's tree of host arrays from the port's parameters of
    ``cfg``: a ``models.gnn.Params`` module, or a mapping from its
    parameter names (``"layers.0.phi_e.w0"``) to tensors, such as the
    gradients of those parameters."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else dict(params))
    tree: dict = {}
    stacked: dict = {}
    for name, t in named.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            stacked.setdefault(tuple(parts[2:]), {})[int(parts[1])] = arr
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    for path, by_layer in stacked.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"layers.*.{'.'.join(path)}: layers "
                             f"{sorted(by_layer)}, config has {cfg.n_layers}")
        node = tree.setdefault("layers", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_layer[i] for i in range(cfg.n_layers)])
    return tree
