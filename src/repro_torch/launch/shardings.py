"""Logical-axis sharding rules -> per-leaf specs for a mesh (the twin of
the reference's ``launch/shardings.py``).

A spec is a tuple with one entry a tensor dim: None (replicated), an
axis name, or a tuple of two or more names (that dim split over those
axes, major to minor) — a ``PartitionSpec`` entry for entry, which also
writes one axis as its name and none as None.  One rule table drives
every architecture; each dimension is sharded over its logical axis only
when the size divides the mesh axis (else replicated), so the same model
lays out on the 16x16 pod, the 2x16x16 multi-pod and any smaller shape.

Baseline layout (the reference's):
  * batch        -> ("pod", "data")     [DP across pods and data axis]
  * TP (heads, d_ff, vocab)   -> "model"
  * FSDP (param d_model dims) -> "data"
  * GNN nodes/edges, engine pair tables -> all axes flattened
  * MoE experts  -> replicated, expert d_ff over "model"

``mesh`` is a ``DeviceMesh`` or a plain ``(axis_names, shape)`` value
(``launch.mesh.names_and_shape``); :func:`placements` turns a spec into
DTensor placements, :func:`distribute` places a tensor by it and
:func:`distribute_tree` a parameter module, an AdamW state or a batch by
a spec tree.  :func:`lm_layout` makes the reference's four layout
choices (``launch/steps.py`` ``_lm_layout_from_env``), as keyword
arguments at its defaults.
"""

from __future__ import annotations

import dataclasses

from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from ..train.optim import AdamWState
from .mesh import axis_size, batch_axes, flat_axes, names_and_shape


def _ok(size: int, mesh, axis) -> bool:
    if axis is None:
        return True
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= axis_size(mesh, a)
    return size % n == 0


def _entry(axes):
    """One spec entry: a tuple of one axis is its name, of none None."""
    if isinstance(axes, tuple) and len(axes) < 2:
        return axes[0] if axes else None
    return axes


def _spec(mesh, *dim_axis_pairs) -> tuple:
    """A spec, dropping axes that don't divide."""
    return tuple(_entry(axis) if (axis and _ok(size, mesh, axis)) else None
                 for size, axis in dim_axis_pairs)


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec``, one a mesh dim: ``Shard(d)``
    where tensor dim ``d`` names the mesh dim's axis, else
    ``Replicate()``.  Axes sharing one tensor dim must come in mesh order
    (major to minor, as JAX takes them); out of order, or an axis named
    twice, raises rather than reorders."""
    names, _ = names_and_shape(mesh)
    out = [Replicate() for _ in names]
    taken: set = set()
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec}: no mesh axis {missing} in {names}")
        at = [names.index(a) for a in axes]
        if at != sorted(at):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in mesh order {names}")
        for i in at:
            if i in taken:
                raise ValueError(f"spec {spec}: axis {names[i]!r} named twice")
            taken.add(i)
            out[i] = Shard(dim)
    return out


def distribute(tensor, spec: tuple, mesh):
    """``tensor`` as a DTensor over the ``DeviceMesh`` ``mesh``, laid out
    by ``spec``: every rank passes the same global tensor and keeps its
    own slice of it (nothing is sent)."""
    out = distribute_tensor(tensor, mesh, placements(spec, mesh),
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage()._cdata != tensor.untyped_storage()._cdata:
        return out
    # a slice of the global tensor: a storage of its own, so that the
    # global one can go (and the meta device's reckoning counts a shard)
    return DTensor.from_local(local.clone(), mesh, out.placements,
                              run_check=False, shape=out.shape,
                              stride=out.stride())


def _is_spec(node) -> bool:
    return isinstance(node, tuple) and not hasattr(node, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in node)


def spec_of(name: str, spec_tree) -> tuple:
    """The spec of the parameter ``name`` (``"layers.3.wq"``, as
    ``named_parameters`` spells it) in a spec tree of the reference's
    layout, whose layer leaves are stacked on a leading axis: an integer
    component picks one entry of that axis, so its leading spec entry is
    dropped."""
    node, stacked = spec_tree, 0
    for part in name.split("."):
        if part.isdigit():
            stacked += 1
            continue
        node = node[part]
    if not _is_spec(node):
        raise ValueError(f"{name}: no spec (got {node!r})")
    return node[stacked:]


def distribute_tree(tree, spec_tree, mesh):
    """``tree`` laid out on ``mesh`` by ``spec_tree``: a parameter module
    (``models.gnn.Params``) has its parameters replaced by DTensor
    parameters in place and is returned; a mapping of parameter names to
    tensors (an AdamW moment tree) or a spec-shaped dict, tuple or named
    tuple of tensors is returned laid out.  An ``AdamWState`` keeps its
    step counter a plain tensor."""
    if tree is None:
        return None
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            owner = tree.get_submodule(name.rpartition(".")[0])
            owner._parameters[name.rpartition(".")[2]] = nn.Parameter(
                distribute(p.detach(), spec_of(name, spec_tree), mesh),
                requires_grad=p.requires_grad)
        return tree
    if isinstance(tree, AdamWState):
        return AdamWState(tree.step,
                          distribute_tree(tree.mu, spec_tree.mu, mesh),
                          distribute_tree(tree.nu, spec_tree.nu, mesh))
    if isinstance(tree, dict):
        if all(k in spec_tree for k in tree):
            return {k: distribute_tree(v, spec_tree[k], mesh)
                    for k, v in tree.items()}
        return {k: distribute(v, spec_of(k, spec_tree), mesh)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute_tree(v, s, mesh)
                            for v, s in zip(tree, spec_tree)))
    return distribute(tree, spec_tree, mesh)


# ---------------------------------------------------------------------- #
# LM
# ---------------------------------------------------------------------- #


def lm_param_specs(cfg, mesh, fsdp: str | tuple | None = "data",
                   embed_fsdp: bool = True) -> dict:
    """Specs of the LM parameter tree (the reference's layout: stacked
    layers).  ``embed_fsdp=False`` keeps the embedding's d_model dim
    replicated."""
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    v, nl = cfg.padded_vocab, cfg.n_layers
    m = "model"
    efsdp = fsdp if embed_fsdp else None
    layer = {
        "attn_norm": (None, None),
        "wq": _spec(mesh, (nl, None), (d, fsdp), (h * hd, m)),
        "wk": _spec(mesh, (nl, None), (d, fsdp), (kv * hd, m)),
        "wv": _spec(mesh, (nl, None), (d, fsdp), (kv * hd, m)),
        "wo": _spec(mesh, (nl, None), (h * hd, m), (d, fsdp)),
        "mlp_norm": (None, None),
    }
    if cfg.gemma_norms:
        layer["post_attn_norm"] = (None, None)
        layer["post_mlp_norm"] = (None, None)
    if cfg.is_moe:
        e = cfg.n_experts
        layer["router"] = _spec(mesh, (nl, None), (d, fsdp), (e, None))
        layer["w_gate"] = _spec(mesh, (nl, None), (e, None), (d, fsdp), (f, m))
        layer["w_up"] = _spec(mesh, (nl, None), (e, None), (d, fsdp), (f, m))
        layer["w_down"] = _spec(mesh, (nl, None), (e, None), (f, m), (d, fsdp))
    else:
        layer["w_gate"] = _spec(mesh, (nl, None), (d, fsdp), (f, m))
        layer["w_up"] = _spec(mesh, (nl, None), (d, fsdp), (f, m))
        layer["w_down"] = _spec(mesh, (nl, None), (f, m), (d, fsdp))
    specs = {
        "embed": _spec(mesh, (v, m), (d, efsdp)),
        "final_norm": (None,),
        "layers": layer,
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _spec(mesh, (d, efsdp), (v, m))
    return specs


def lm_layout(cfg, mesh, *, fsdp="data", embed_fsdp: bool = True,
              context_parallel: bool = True, moe_tp: bool = False):
    """``(cfg, param_specs)`` of the reference's ``lm_cell`` on ``mesh``:
    ``fsdp`` the axes the parameters' d_model dims shard over (a name, a
    tuple, or None), ``embed_fsdp`` whether the embedding's does too;
    ``context_parallel`` (on) shards attention's sequence over "model"
    when the heads do not divide it; ``moe_tp`` (off) shards the MoE
    buffers' capacity over "model" with the experts' d_ff replicated.
    Axes the mesh lacks are dropped from ``fsdp``."""
    names, _ = names_and_shape(mesh)
    if isinstance(fsdp, tuple):
        fsdp = tuple(a for a in fsdp if a in names)
        fsdp = fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)
    elif fsdp not in names:
        fsdp = None
    tp = axis_size(mesh, "model") if "model" in names else 1
    baxes = batch_axes(mesh)
    if context_parallel and cfg.n_heads % tp != 0:
        cfg = dataclasses.replace(cfg, attn_batch_axes=baxes,
                                  attn_seq_axes=("model",))
    if moe_tp and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_c_axes=("model",),
                                  attn_batch_axes=baxes)
    specs = lm_param_specs(cfg, mesh, fsdp=fsdp, embed_fsdp=embed_fsdp)
    if moe_tp and cfg.is_moe:
        nl, e, d, f = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff
        lay = specs["layers"]
        lay["w_gate"] = _spec(mesh, (nl, None), (e, None), (d, fsdp), (f, None))
        lay["w_up"] = _spec(mesh, (nl, None), (e, None), (d, fsdp), (f, None))
        lay["w_down"] = _spec(mesh, (nl, None), (e, None), (f, None), (d, fsdp))
    return cfg, specs


def lm_batch_spec(mesh) -> tuple:
    return (_entry(batch_axes(mesh)), None)


def lm_cache_specs(cfg, mesh) -> dict:
    """KV cache (L, B, T, KV, hd): batch over the data axes; kv heads over
    model when divisible, else the *time* axis over model."""
    baxes = _entry(batch_axes(mesh))
    if _ok(cfg.n_kv_heads, mesh, "model"):
        spec = (None, baxes, None, "model", None)
    else:
        spec = (None, baxes, "model", None, None)
    return {"k": spec, "v": spec}


def lm_opt_specs(param_specs: dict) -> AdamWState:
    """AdamW moments shard exactly like their params."""
    return AdamWState(step=(), mu=_copy(param_specs), nu=_copy(param_specs))


# ---------------------------------------------------------------------- #
# GNN — nodes/edges flattened over every axis
# ---------------------------------------------------------------------- #


def gnn_batch_specs(mesh, n_nodes: int, n_edges: int) -> dict:
    axes = _entry(flat_axes(mesh))
    size = 1
    for n in names_and_shape(mesh)[1]:
        size *= n

    def rowspec(n):
        return (axes, None) if n % size == 0 else ()

    def rowspec1(n):
        return (axes,) if n % size == 0 else ()

    return {
        "node_feat": rowspec(n_nodes),
        "edge_feat": rowspec(n_edges),
        "senders": rowspec1(n_edges),
        "receivers": rowspec1(n_edges),
        "node_mask": rowspec1(n_nodes),
        "edge_mask": rowspec1(n_edges),
        "positions": rowspec(n_nodes),
        "graph_ids": rowspec1(n_nodes),
    }


def gnn_param_specs(params, mesh) -> dict:
    """GNN params are small: replicated.  ``params`` is the reference's
    tree (``convert.gnn_params_to_numpy``) or the port's parameter module
    (``models.gnn.Params``; its layers are the reference's stacked
    leaves)."""
    if isinstance(params, nn.Module):
        tree: dict = {}
        for name, _ in params.named_parameters():
            *parents, leaf = [k for k in name.split(".") if not k.isdigit()]
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = ()
        return tree
    if isinstance(params, dict):
        return {k: gnn_param_specs(v, mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(gnn_param_specs(v, mesh) for v in params)
    return ()


# ---------------------------------------------------------------------- #
# recsys
# ---------------------------------------------------------------------- #


def bst_param_specs(cfg, mesh) -> dict:
    """Embedding tables row-sharded over "model" (the big memory);
    dense layers replicated."""
    m = "model"
    return {
        "item_emb": _spec(mesh, (cfg.n_items, m), (cfg.embed_dim, None)),
        "cat_emb": _spec(mesh, (cfg.n_cats, m), (cfg.embed_dim, None)),
        "ctx_emb": _spec(mesh, (cfg.n_context, m), (cfg.embed_dim, None)),
        "pos_emb": (None, None),
        "blocks": {
            k: (None,) * nd
            for k, nd in [("wq", 3), ("wk", 3), ("wv", 3), ("wo", 3),
                          ("ff1", 3), ("ff2", 3), ("ln1", 2), ("ln2", 2)]
        },
        "mlp": {k: (None, None) if k.startswith("w") else (None,)
                for k in _bst_mlp_keys(cfg)},
    }


def _bst_mlp_keys(cfg):
    n = len(cfg.mlp_dims) + 1
    return [f"w{i}" for i in range(n)] + [f"b{i}" for i in range(n)]


def bst_batch_spec(mesh) -> tuple:
    return (_entry(batch_axes(mesh)),)
