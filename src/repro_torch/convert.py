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
``models.gnn.Params`` module (one ``nn.ModuleList`` entry a layer);
``lm_params_*`` for an LM's (``layers``) and ``bst_params_*`` for BST's
(``blocks``) likewise, bfloat16 included (as raw ``uint16`` bits on the
numpy side)."""

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


def _leaf_from_numpy(arr, dev, dtype) -> torch.Tensor:
    """A tensor of ``dtype`` on ``dev`` from a host array: a bfloat16 leaf
    comes as the reference's ``ml_dtypes`` array or as the raw ``uint16``
    view that :func:`_leaf_to_numpy` gives (numpy has no bfloat16)."""
    arr = np.asarray(arr)
    if dtype == torch.bfloat16 and arr.dtype.name in ("bfloat16", "uint16"):
        raw = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(arr)).to(dev)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # raw bits: numpy has no bfloat16
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _params_from_tree(tree: Mapping, stacked: str, n: int, dev, dtype=None):
    """``models.gnn.Params`` from the reference's tree: nested mappings
    become ``Params``, the ``stacked`` subtree (each leaf on a leading
    axis of ``n``) an ``nn.ModuleList`` of ``n`` entries."""
    from .models.gnn import Params

    def build(node):
        if isinstance(node, Mapping):
            return Params(**{k: build(node[k]) for k in node})
        return _leaf_from_numpy(node, dev, dtype)

    def entry(node, i):
        if isinstance(node, Mapping):
            return {k: entry(node[k], i) for k in node}
        if np.shape(node)[0] != n:
            raise ValueError(f"a {stacked} leaf of {np.shape(node)} is not "
                             f"stacked over {n} entries")
        return np.asarray(node)[i]

    top = {k: build(v) for k, v in tree.items() if k != stacked}
    entries = nn.ModuleList(build(entry(tree[stacked], i)) for i in range(n))
    return Params(**top, **{stacked: entries})


def _params_to_tree(params, stacked: str, n: int) -> dict:
    """The reference's tree of host arrays from a ``Params`` module, or a
    mapping from its parameter names (``"layers.0.wq"``) to tensors such
    as their gradients; the ``stacked`` entries' leaves are stacked on a
    leading axis of ``n``."""
    named = (dict(params.named_parameters()) if isinstance(params, nn.Module)
             else dict(params))
    tree: dict = {}
    by_entry: dict = {}
    for name, t in named.items():
        arr = _leaf_to_numpy(t)
        parts = name.split(".")
        if parts[0] == stacked:
            by_entry.setdefault(tuple(parts[2:]), {})[int(parts[1])] = arr
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = arr
    for path, entries in by_entry.items():
        if sorted(entries) != list(range(n)):
            raise ValueError(f"{stacked}.*.{'.'.join(path)}: entries "
                             f"{sorted(entries)}, config has {n}")
        node = tree.setdefault(stacked, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([entries[i] for i in range(n)])
    return tree


def gnn_params_from_numpy(cfg, tree: Mapping, device=None):
    """The port's parameters of ``cfg`` (a ``models.gnn.GNNConfig``) from
    the reference's tree of host arrays, on the CUDA card unless
    ``device`` names another.  Leaves keep their dtype and values."""
    return _params_from_tree(tree, "layers", cfg.n_layers,
                             resolve_device(device))


def gnn_params_to_numpy(cfg, params) -> dict:
    """The reference's tree of host arrays from the port's parameters of
    ``cfg``: a ``models.gnn.Params`` module, or a mapping from its
    parameter names (``"layers.0.phi_e.w0"``) to tensors, such as the
    gradients of those parameters."""
    return _params_to_tree(params, "layers", cfg.n_layers)


def lm_params_from_numpy(cfg, tree: Mapping, device=None):
    """The port's parameters of ``cfg`` (a ``models.transformer.LMConfig``)
    from the reference's tree (``embed``, ``final_norm``, ``lm_head`` when
    untied, ``layers`` stacked over ``n_layers``), on the CUDA card unless
    ``device`` names another.  A bfloat16 leaf may come as an
    ``ml_dtypes`` array or as its raw ``uint16`` bits."""
    return _params_from_tree(tree, "layers", cfg.n_layers,
                             resolve_device(device), cfg.dtype)


def lm_params_to_numpy(cfg, params) -> dict:
    """The reference's tree of host arrays from the port's LM parameters;
    bfloat16 leaves as their raw ``uint16`` bits (the checkpoint's
    convention: ``arr.view(ml_dtypes.bfloat16)`` reads them back)."""
    return _params_to_tree(params, "layers", cfg.n_layers)


def bst_params_from_numpy(cfg, tree: Mapping, device=None):
    """The port's BST parameters of ``cfg`` (a ``models.recsys.BSTConfig``)
    from the reference's tree (the embeddings, ``blocks`` stacked over
    ``n_blocks``, ``mlp``), on the CUDA card unless ``device`` names
    another."""
    return _params_from_tree(tree, "blocks", cfg.n_blocks,
                             resolve_device(device), cfg.dtype)


def bst_params_to_numpy(cfg, params) -> dict:
    """The reference's tree of host arrays from the port's BST parameters
    (bfloat16 leaves as raw ``uint16``)."""
    return _params_to_tree(params, "blocks", cfg.n_blocks)
