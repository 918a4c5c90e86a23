"""Steps of the port: the concrete counterparts of the step functions that
the reference's ``launch/steps.py`` cells lower, eager, on the card.

- :func:`gnn_step` — ``gnn_cell``'s train step: the masked loss, its
  gradients, one ``adamw_update``;
- :func:`lm_prefill_step`, :func:`lm_decode_step` — ``lm_cell``'s
  ``prefill`` and ``decode`` kinds (``transformer.prefill`` /
  ``decode_step``; the cache is written in place, where the cells donate
  it);
- :func:`lm_train_step` — ``lm_cell``'s ``train`` kind: ``accum``
  microbatches, float32 gradients summed, one ``adamw_update``;
- :func:`bst_serve_step`, :func:`bst_retrieval_step` — ``bst_cell``'s
  ``serve`` and ``retrieval`` kinds (``recsys.forward`` /
  ``retrieval_topk`` at k = 128); :func:`bst_train_step` its ``train``
  kind;
- :func:`engine_build_step`, :func:`engine_query_step` — ``engine_cell``'s
  distributed level join and conjunction query step over a
  ``distributed.ShardMesh``.

Each runs on the CUDA card unless ``device`` (for the engine steps, the
mesh) names another, and refuses inputs that lie elsewhere.

:func:`build_cell` is the twin of the reference's ``build_cell``: one
(architecture x input shape) cell as a :class:`Cell` — the step and its
inputs, made directly on ``device`` at the reference's shapes and dtypes.
On the meta device nothing is allocated, so ``launch.dryrun`` reckons a
cell far too big for the card.  Given a ``DeviceMesh``, a cell lays its
inputs out by the reference's sharding rules (``launch.shardings``) and
the same steps run on them: an LM or BST cell's parameters, optimizer
state, batches and cache as DTensors; a GNN cell's node and edge rows
over every mesh dimension (N and E padded to the mesh's size) with the
parameters replicated; an engine cell's relations one shard a rank over
the mesh's flattened group (``distributed.mesh_of_device_mesh``).  Over
a real group (gloo) each rank computes its shards; over
``launch.mesh.reckoning_mesh``'s fake group, on the meta device, one
rank's step is reckoned.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch.distributed.tensor import Replicate

from ..core import distributed as D
from ..core.index import resolve_device
from ..models import gnn as G
from ..models import layers as L
from ..models import recsys as RS
from ..models import transformer as T
from ..train.optim import AdamWState, adamw_init, adamw_update
from . import shardings as S
from .mesh import names_and_shape

# per-arch gradient-accumulation factor at the train_4k shape (the
# reference's, sized there for per-device saved activations)
TRAIN_ACCUM = {
    "grok-1-314b": 16,
    "mistral-nemo-12b": 8,
    "gemma2-2b": 4,
    "minicpm-2b": 4,
    "granite-moe-3b-a800m": 4,
}


def _on(dev, **tensors) -> None:
    for what, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"the step runs on {dev}; its {what} lie on "
                             f"{t.device}")


def _first(params) -> torch.Tensor:
    return next(params.parameters())


def gnn_step(cfg: G.GNNConfig, lr: float = 1e-3, device=None):
    """``step(params, opt_state, g, targets) -> (params, opt_state,
    metrics)`` for ``cfg`` on the CUDA card unless ``device`` names
    another; ``params`` (a ``models.gnn.Params`` module) is updated in
    place and returned, ``metrics`` holds ``loss``, ``grad_norm`` and
    ``clip_scale``.  Inputs on any other device are refused."""
    dev = resolve_device(device)

    def step(params, opt_state: AdamWState, g: G.GraphBatch,
             targets: torch.Tensor):
        named = dict(params.named_parameters())
        _on(dev, params=next(iter(named.values())), graph=g.node_feat,
            targets=targets)
        loss, _ = G.train_loss(cfg, params, g, targets)
        # EGNN's last coordinate MLP feeds no output: its grads are zeros
        new, new_opt, om = adamw_update(_grads(loss, named), opt_state,
                                        named, lr=lr)
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(new[name])
        return params, new_opt, {"loss": loss.detach(), **om}

    return step


def _grads(loss, named: dict) -> dict:
    """d loss / d each parameter, by name (zeros for an unused one)."""
    return dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), allow_unused=True,
        materialize_grads=True)))


def lm_train_step(cfg: T.LMConfig, accum: int = 1, lr: float = 3e-4,
                  device=None):
    """``step(params, opt_state, tokens, labels) -> (params, opt_state,
    metrics)``: the global batch (GB, S) splits into ``accum``
    microbatches on its leading axis, each one's gradients are summed in
    float32 and the sum divided by ``accum`` (the loss likewise), then
    one ``adamw_update`` at ``lr``.  ``params`` (a ``models.gnn.Params``
    module) and ``opt_state``'s moments are updated in place (the
    reference's cell donates both) and returned; ``metrics`` holds
    ``loss``, ``grad_norm`` and ``clip_scale``.  Inputs on any other
    device are refused."""
    dev = resolve_device(device)

    def step(params, opt_state: AdamWState, tokens: torch.Tensor,
             labels: torch.Tensor):
        named = dict(params.named_parameters())
        _on(dev, params=next(iter(named.values())), tokens=tokens,
            labels=labels)

        def micro(toks, labs):
            loss, _ = T.train_loss(cfg, params, toks, labs)
            return loss.detach(), _grads(loss, named)

        if accum == 1:
            loss, grads = micro(tokens, labels)
        else:
            gb, seq = tokens.shape
            toks = _whole(tokens).reshape(accum, gb // accum, seq)
            labs = _whole(labels).reshape(accum, gb // accum, seq)
            # the float32 sums keep each parameter's placements
            grads = {k: torch.zeros_like(p, dtype=torch.float32,
                                         memory_format=torch.contiguous_format)
                     for k, p in named.items()}
            loss = 0.0
            for i in range(accum):
                loss_i, g = micro(L.pin_batch(toks[i]), L.pin_batch(labs[i]))
                for k, gi in g.items():
                    grads[k].add_(gi)
                loss = loss + loss_i
                del g  # free this microbatch's gradients before the next
            for g in grads.values():
                g.div_(accum)
            loss = loss / accum
        if L.is_dtensor(loss):
            loss = loss.full_tensor()
        _, new_opt, om = adamw_update(grads, opt_state, named, lr=lr,
                                      inplace=True)
        return params, new_opt, {"loss": loss, **om}

    return step


def _whole(t):
    """A batch DTensor replicated (its microbatches are then split anew,
    as the reference's reshape splits the global batch); a plain tensor
    as it is."""
    if not L.is_dtensor(t):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def lm_prefill_step(cfg: T.LMConfig, device=None):
    """``step(params, tokens, cache) -> (last-token logits, cache)``."""
    dev = resolve_device(device)

    def step(params, tokens: torch.Tensor, cache: dict):
        _on(dev, params=_first(params), tokens=tokens, cache=cache["k"])
        return T.prefill(cfg, params, tokens, cache)

    return step


def lm_decode_step(cfg: T.LMConfig, device=None):
    """``step(params, cache, tokens (B, 1), pos) -> (logits, cache)``."""
    dev = resolve_device(device)

    def step(params, cache: dict, tokens: torch.Tensor, pos):
        _on(dev, params=_first(params), tokens=tokens, cache=cache["k"])
        return T.decode_step(cfg, params, cache, tokens, pos)

    return step


def bst_serve_step(cfg: RS.BSTConfig, device=None):
    """``step(params, batch) -> CTR logits (B,)``, ``batch`` a
    ``recsys.BSTBatch`` of tensors."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, batch: RS.BSTBatch):
        _on(dev, params=_first(params), batch=batch.item_ids)
        return RS.forward(cfg, params, batch)

    return step


def bst_retrieval_step(cfg: RS.BSTConfig, k: int = 128, device=None):
    """``step(params, item_ids, cat_ids, ctx_ids, ctx_segs, cand_ids) ->
    (values, candidate ids)`` of the ``k`` best candidates."""
    dev = resolve_device(device)

    @torch.no_grad()
    def step(params, item_ids, cat_ids, ctx_ids, ctx_segs, cand_ids):
        _on(dev, params=_first(params), inputs=item_ids, candidates=cand_ids)
        return RS.retrieval_topk(cfg, params, item_ids, cat_ids, ctx_ids,
                                 ctx_segs, cand_ids, k=k)

    return step


def bst_train_step(cfg: RS.BSTConfig, lr: float = 1e-3, device=None):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``recsys.train_loss``, its gradients, one ``adamw_update`` at ``lr``;
    ``params`` and the moments are updated in place (as in
    :func:`lm_train_step`) and returned."""
    dev = resolve_device(device)

    def step(params, opt_state: AdamWState, batch: RS.BSTBatch):
        named = dict(params.named_parameters())
        _on(dev, params=next(iter(named.values())), batch=batch.item_ids)
        loss, _ = RS.train_loss(cfg, params, batch)
        _, new_opt, om = adamw_update(_grads(loss, named), opt_state, named,
                                      lr=lr, inplace=True)
        loss = loss.detach()
        if L.is_dtensor(loss):
            loss = loss.full_tensor()
        return params, new_opt, {"loss": loss, **om}

    return step


# ---------------------------------------------------------------------- #
# engine cells (the paper's workload at scale)
# ---------------------------------------------------------------------- #


def engine_build_step(spec, shape, mesh: D.ShardMesh):
    """``step(a0, a1, a2, an, b0, b1, b2, bn) -> (cols, counts,
    overflow)``: the distributed level join (v, m, x) ⋈ (m, u, y) of two
    sharded arity-3 relations — the shards this process holds, columns
    (mesh.n_local, cap), counts (mesh.n_local,) — over ``mesh`` at
    ``shape``'s caps: ``per = n_pairs // n_shards`` rows a shard,
    exchange buckets of ``max(per // n_shards * 4, 1024)`` rows, ``4 *
    per`` output rows a shard.  The rows move through ``mesh.exchange``:
    in process, or one process a shard (``make_process_mesh``)."""
    total = mesh.n_shards
    per = shape.dims["n_pairs"] // total
    join = D.make_distributed_join(mesh, mesh.axis, total, 3, 3,
                                   bucket_cap=max(per // total * 4, 1024),
                                   out_cap=4 * per)

    def step(a0, a1, a2, an, b0, b1, b2, bn):
        _on(mesh.device, relations=a0, counts=an, build=b0)
        return join((a0, a1, a2), an, (b0, b1, b2), bn)

    return step


def engine_query_step(spec, shape, mesh: D.ShardMesh):
    """``step(ca, cb, c2p_cls, c2p_v, c2p_u, c2p_count) -> ((v, u),
    counts)``: the conjunction of two replicated class lists, then each
    held shard's slice of ``I_c2p`` ((mesh.n_local, cap) columns)
    filtered to the surviving classes."""
    query = D.make_distributed_query_step(mesh, mesh.axis)

    def step(ca, cb, c2p_cls, c2p_v, c2p_u, c2p_count):
        _on(mesh.device, classes=ca, c2p=c2p_cls, counts=c2p_count)
        return query(ca, cb, c2p_cls, c2p_v, c2p_u, c2p_count)

    return step


# ---------------------------------------------------------------------- #
# cells: a step and its inputs at one (architecture x shape)
# ---------------------------------------------------------------------- #

ENGINE_SHARDS = 4  # the engine cells' in-process shards on one card
# what a cell's ``**reduce`` may cut besides a shape's dims and a config's
# fields: microbatches a train step, in-process shards, rows a shard block
# (the last two not on a mesh, whose size fixes both)
CELL_KNOBS = ("accum", "n_shards", "block_rows")

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class Cell:
    """The reference's ``Cell``: ``fn(*args)`` runs the step;
    ``mesh_shape`` names the mesh's axes and sizes (``{"card": 1}`` on
    one card, the engine's in-process shards); ``reduced`` the cuts
    ``build_cell`` was given."""

    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    device: torch.device
    mesh_shape: dict
    reduced: dict
    description: str = ""
    n_devices: int = 1
    axis_of_group: dict = dataclasses.field(default_factory=dict)


def build_cell(spec, shape, device="meta", mesh=None, **reduce) -> Cell:
    """The cell of ``spec`` (a ``configs.ArchSpec``) at ``shape`` on
    ``device`` (the meta device by default), laid out on ``mesh`` (a
    ``DeviceMesh``; None for one device).  ``reduce`` cuts it: a key of
    ``shape.dims`` (``global_batch``, ``seq_len``, ``batch``, ...), a field
    of ``spec.config`` (``n_layers``, ...), or one of ``CELL_KNOBS``
    (``n_shards`` and ``block_rows`` raise on a mesh)."""
    dims, changes, knobs = dict(shape.dims), {}, {}
    for key, value in reduce.items():
        if key in dims:
            dims[key] = value
        elif key in CELL_KNOBS:
            knobs[key] = value
        elif hasattr(spec.config, key):
            changes[key] = value
        else:
            raise ValueError(f"{spec.arch_id}: cannot reduce {key!r}")
    cfg = dataclasses.replace(spec.config, **changes) if changes \
        else spec.config
    dev = torch.device(device)
    if mesh is not None:
        taken = [k for k in ("n_shards", "block_rows") if k in knobs]
        if taken:
            raise ValueError(f"{spec.arch_id}: {taken} are the mesh's to "
                             "set, not a cut")
        knobs["mesh"] = mesh
    make = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _bst_cell,
            "engine": _engine_cell}[spec.family]
    fn, args, mesh_shape, description = make(spec, cfg, shape, dims, knobs,
                                             dev)
    cell = Cell(spec.arch_id, shape.name, fn, args, dev, mesh_shape,
                dict(reduce), description)
    if mesh is not None:
        cell.n_devices = mesh.size()
        cell.axis_of_group = {mesh.get_group(i).group_name: name
                              for i, name in enumerate(mesh.mesh_dim_names)}
    return cell


def _zeros(shape, dtype, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=dev)


def _generator(dev) -> torch.Generator:
    """A seeded generator where a device can draw (the meta device draws
    nothing)."""
    on = dev if dev.type == "cuda" else torch.device("cpu")
    return torch.Generator(device=on).manual_seed(0)


def _mesh_shape(mesh) -> dict:
    if mesh is None:
        return {"card": 1}
    return dict(zip(*names_and_shape(mesh)))


def _laid(mesh, tree, specs):
    """``tree`` laid out by ``specs`` on ``mesh``; as it is without one
    (``specs`` may then be anything)."""
    return tree if mesh is None else S.distribute_tree(tree, specs, mesh)


def _lm_cell(spec, cfg, shape, dims, knobs, dev):
    mesh, pspecs = knobs.get("mesh"), None
    if mesh is not None:
        cfg, pspecs = S.lm_layout(cfg, mesh)
    params = _laid(mesh, T.init_params(cfg, _generator(dev), dev), pspecs)
    # the RoPE table the model caches per device is made here, beside the
    # inputs, as it stands resident on a card that has run the model
    L.rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, dev)
    b, seq = dims["global_batch"], dims["seq_len"]
    where = _mesh_shape(mesh)
    bspec = S.lm_batch_spec(mesh) if mesh is not None else None
    if shape.kind == "train":
        accum = knobs.get("accum", TRAIN_ACCUM.get(spec.arch_id, 1))
        opt = adamw_init(dict(params.named_parameters()))
        toks = _laid(mesh, _zeros((b, seq), I32, dev), bspec)
        labs = _laid(mesh, _zeros((b, seq), I32, dev), bspec)
        return (lm_train_step(cfg, accum, device=dev),
                (params, opt, toks, labs), where,
                f"train {b}x{seq} accum={accum}")
    cache = T.make_cache(cfg, b, seq, device=dev)
    if mesh is not None:
        names, sizes = names_and_shape(mesh)
        if b % math.prod(s for a, s in zip(names, sizes)
                         if a != "model") == 0:
            cspecs = S.lm_cache_specs(cfg, mesh)
        else:
            # the reference's tiny-batch long-context layout: the KV time
            # over the whole mesh (flash-decoding style), batch replicated
            every = names if len(names) > 1 else names[0]
            cspecs = {"k": (None, None, every, None, None),
                      "v": (None, None, every, None, None)}
            bspec = (None, None)
        cache = S.distribute_tree(cache, cspecs, mesh)
    if shape.kind == "prefill":
        return (lm_prefill_step(cfg, device=dev),
                (params, _laid(mesh, _zeros((b, seq), I32, dev), bspec),
                 cache), where, f"prefill {b}x{seq}")
    if shape.kind == "decode":  # one token a sequence into the last slot
        return (lm_decode_step(cfg, device=dev),
                (params, cache, _laid(mesh, _zeros((b, 1), I32, dev), bspec),
                 seq - 1), where, f"decode b={b} kv={seq}")
    raise ValueError(shape.kind)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _gnn_cell(spec, cfg, shape, dims, knobs, dev):
    mesh = knobs.get("mesh")
    d_feat = dims.get("d_feat", cfg.d_in)
    cfg = dataclasses.replace(cfg, d_in=d_feat)
    if shape.kind == "sampled":
        n, e = dims["pad_nodes"], dims["pad_edges"]
    elif shape.kind == "batched_graphs":
        n, e = dims["n_nodes"] * dims["batch"], dims["n_edges"] * dims["batch"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
    if mesh is not None:  # the padding is masked out
        n, e = _round_up(n, mesh.size()), _round_up(e, mesh.size())
    pos = cfg.arch in ("egnn", "mace")
    g = G.GraphBatch(
        node_feat=_zeros((n, d_feat), F32, dev),
        edge_feat=(_zeros((e, max(cfg.d_edge_in, 1)), F32, dev)
                   if cfg.d_edge_in else None),
        senders=_zeros((e,), I32, dev), receivers=_zeros((e,), I32, dev),
        node_mask=_zeros((n,), torch.bool, dev),
        edge_mask=_zeros((e,), torch.bool, dev),
        positions=_zeros((n, 3), F32, dev) if pos else None,
        graph_ids=_zeros((n,), I32, dev), n_graphs=1)
    params = G.init_params(cfg, _generator(dev), dev)
    targets = _zeros((n, cfg.d_out), F32, dev)
    if mesh is not None:
        g, targets = gnn_laid_out(g, targets, mesh)
        params = S.distribute_tree(params, S.gnn_param_specs(params, mesh),
                                   mesh)
    opt = adamw_init(dict(params.named_parameters()))
    return (gnn_step(cfg, lr=1e-3, device=dev), (params, opt, g, targets),
            _mesh_shape(mesh), f"gnn train N={n} E={e}")


def gnn_laid_out(g: G.GraphBatch, targets, mesh):
    """``(g, targets)`` as DTensors laid out on ``mesh`` by the
    reference's ``gnn_batch_specs``: every row field's rows, and the
    targets' like the node features, over every mesh dimension (where N
    and E divide the mesh's size; else replicated)."""
    specs = S.gnn_batch_specs(mesh, g.node_feat.shape[0], g.senders.shape[0])
    return (G.GraphBatch(*(
        S.distribute(t, specs[name], mesh) if isinstance(t, torch.Tensor)
        else t for name, t in zip(g._fields, g))),
        S.distribute(targets, specs["node_feat"], mesh))


def _bst_cell(spec, cfg, shape, dims, knobs, dev):
    mesh = knobs.get("mesh")
    params = _laid(mesh, RS.init_params(cfg, _generator(dev), dev),
                   mesh and S.bst_param_specs(cfg, mesh))
    where = _mesh_shape(mesh)
    f = cfg.n_context_fields

    def batch(b):
        one = _zeros((b * f,), I32, dev)
        out = RS.BSTBatch(
            item_ids=_zeros((b, cfg.seq_len), I32, dev),
            cat_ids=_zeros((b, cfg.seq_len), I32, dev),
            ctx_ids=one, ctx_segs=one.clone(),
            labels=_zeros((b,), I32, dev))
        return _laid(mesh, out, mesh and bst_batch_specs(mesh))

    b = dims["batch"]
    if shape.kind == "train":
        opt = adamw_init(dict(params.named_parameters()))
        return (bst_train_step(cfg, lr=1e-3, device=dev),
                (params, opt, batch(b)), where, f"bst train b={b}")
    if shape.kind == "serve":
        return (bst_serve_step(cfg, device=dev), (params, batch(b)),
                where, f"bst serve b={b}")
    if shape.kind == "retrieval":
        nc = dims["n_candidates"]
        seq = [_zeros((1, cfg.seq_len), I32, dev),
               _zeros((1, cfg.seq_len), I32, dev), _zeros((f,), I32, dev),
               _zeros((f,), I32, dev)]
        if mesh is not None:  # the candidates over every axis, the rest
            names = names_and_shape(mesh)[0]  # replicated
            total = math.prod(names_and_shape(mesh)[1])
            nc = _round_up(nc, total)
            seq = [S.distribute(t, (None,) * t.ndim, mesh) for t in seq]
            cand = S.distribute(_zeros((nc,), I32, dev),
                                (names if len(names) > 1 else names[0],),
                                mesh)
        else:
            cand = _zeros((nc,), I32, dev)
        return (bst_retrieval_step(cfg, k=128, device=dev),
                (params, *seq, cand), where, f"bst retrieval 1x{nc}")
    raise ValueError(shape.kind)


def bst_batch_specs(mesh) -> RS.BSTBatch:
    """The reference's ``batch_shard``: every field's rows over the batch
    axes."""
    bs = S.bst_batch_spec(mesh)
    row2 = (bs[0], None)
    return RS.BSTBatch(item_ids=row2, cat_ids=row2, ctx_ids=bs, ctx_segs=bs,
                       labels=bs)


def _engine_cell(spec, cfg, shape, dims, knobs, dev):
    """On one card ``n_shards`` in-process shards; on a ``DeviceMesh`` one
    shard a rank over its flattened group (``per = n_pairs // size`` rows,
    one (1, per) block a rank)."""
    shape = dataclasses.replace(shape, dims=dims)
    if "mesh" in knobs:
        mesh = D.mesh_of_device_mesh(knobs["mesh"], dev)
        total, where = mesh.n_shards, _mesh_shape(knobs["mesh"])
        on = f"one shard a rank of {total} over the flattened mesh"
    else:
        total = knobs.get("n_shards", ENGINE_SHARDS)
        mesh = D.make_mesh(total, device=dev)
        where, on = mesh.shape, f"{total} in-process shards"
    per = dims["n_pairs"] // total
    rows = knobs.get("block_rows", per)
    col, cnt = (mesh.n_local, rows), (mesh.n_local,)
    if shape.name.startswith("build"):
        args = tuple(_zeros(s, I32, dev) for s in (col, col, col, cnt) * 2)
        return (engine_build_step(spec, shape, mesh), args, where,
                f"engine level join {dims['n_pairs']} pairs on {on}")
    lc = dims["lookup_classes"]
    args = tuple(_zeros(s, I32, dev) for s in ((lc,), (lc,), col, col, col,
                                                 cnt))
    return (engine_query_step(spec, shape, mesh), args, where,
            f"engine conjunction query {dims['n_pairs']} pairs on {on}")
