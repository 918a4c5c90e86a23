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
cell far too big for the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core import distributed as D
from ..core.index import resolve_device
from ..models import gnn as G
from ..models import layers as L
from ..models import recsys as RS
from ..models import transformer as T
from ..train.optim import AdamWState, adamw_init, adamw_update

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
            toks = tokens.reshape(accum, gb // accum, seq)
            labs = labels.reshape(accum, gb // accum, seq)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(accum):
                loss_i, g = micro(toks[i], labs[i])
                for k, gi in g.items():
                    grads[k].add_(gi)
                loss = loss + loss_i
                del g  # free this microbatch's gradients before the next
            for g in grads.values():
                g.div_(accum)
            loss = loss / accum
        _, new_opt, om = adamw_update(grads, opt_state, named, lr=lr,
                                      inplace=True)
        return params, new_opt, {"loss": loss, **om}

    return step


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
        return params, new_opt, {"loss": loss.detach(), **om}

    return step


# ---------------------------------------------------------------------- #
# engine cells (the paper's workload at scale)
# ---------------------------------------------------------------------- #


def engine_build_step(spec, shape, mesh: D.ShardMesh):
    """``step(a0, a1, a2, an, b0, b1, b2, bn) -> (cols, counts,
    overflow)``: the distributed level join (v, m, x) ⋈ (m, u, y) of two
    sharded arity-3 relations — columns (n_shards, cap), counts
    (n_shards,) — over ``mesh`` at ``shape``'s caps: ``per = n_pairs //
    n_shards`` rows a shard, exchange buckets of ``max(per // n_shards *
    4, 1024)`` rows, ``4 * per`` output rows a shard."""
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
    shard's slice of ``I_c2p`` filtered to the surviving classes."""
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
CELL_KNOBS = ("accum", "n_shards", "block_rows")

I32 = torch.int32
F32 = torch.float32


@dataclasses.dataclass
class Cell:
    """The reference's ``Cell`` on one card: ``fn(*args)`` runs the step;
    ``mesh_shape`` names the card (or the engine's in-process shards);
    ``reduced`` the cuts ``build_cell`` was given."""

    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    device: torch.device
    mesh_shape: dict
    reduced: dict
    description: str = ""


def build_cell(spec, shape, device="meta", **reduce) -> Cell:
    """The cell of ``spec`` (a ``configs.ArchSpec``) at ``shape`` on
    ``device`` (the meta device by default).  ``reduce`` cuts it: a key of
    ``shape.dims`` (``global_batch``, ``seq_len``, ``batch``, ...), a field
    of ``spec.config`` (``n_layers``, ...), or one of ``CELL_KNOBS``."""
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
    make = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _bst_cell,
            "engine": _engine_cell}[spec.family]
    fn, args, mesh_shape, description = make(spec, cfg, shape, dims, knobs,
                                             dev)
    return Cell(spec.arch_id, shape.name, fn, args, dev, mesh_shape,
                dict(reduce), description)


def _zeros(shape, dtype, dev) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=dev)


def _generator(dev) -> torch.Generator:
    """A seeded generator where a device can draw (the meta device draws
    nothing)."""
    on = dev if dev.type == "cuda" else torch.device("cpu")
    return torch.Generator(device=on).manual_seed(0)


def _lm_cell(spec, cfg, shape, dims, knobs, dev):
    params = T.init_params(cfg, _generator(dev), dev)
    # the RoPE table the model caches per device is made here, beside the
    # inputs, as it stands resident on a card that has run the model
    L.rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, dev)
    b, seq = dims["global_batch"], dims["seq_len"]
    card = {"card": 1}
    if shape.kind == "train":
        accum = knobs.get("accum", TRAIN_ACCUM.get(spec.arch_id, 1))
        opt = adamw_init(dict(params.named_parameters()))
        toks = _zeros((b, seq), I32, dev)
        return (lm_train_step(cfg, accum, device=dev),
                (params, opt, toks, _zeros((b, seq), I32, dev)), card,
                f"train {b}x{seq} accum={accum}")
    cache = T.make_cache(cfg, b, seq, device=dev)
    if shape.kind == "prefill":
        return (lm_prefill_step(cfg, device=dev),
                (params, _zeros((b, seq), I32, dev), cache), card,
                f"prefill {b}x{seq}")
    if shape.kind == "decode":  # one token a sequence into the last slot
        return (lm_decode_step(cfg, device=dev),
                (params, cache, _zeros((b, 1), I32, dev), seq - 1), card,
                f"decode b={b} kv={seq}")
    raise ValueError(shape.kind)


def _gnn_cell(spec, cfg, shape, dims, knobs, dev):
    d_feat = dims.get("d_feat", cfg.d_in)
    cfg = dataclasses.replace(cfg, d_in=d_feat)
    if shape.kind == "sampled":
        n, e = dims["pad_nodes"], dims["pad_edges"]
    elif shape.kind == "batched_graphs":
        n, e = dims["n_nodes"] * dims["batch"], dims["n_edges"] * dims["batch"]
    else:
        n, e = dims["n_nodes"], dims["n_edges"]
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
    opt = adamw_init(dict(params.named_parameters()))
    return (gnn_step(cfg, lr=1e-3, device=dev),
            (params, opt, g, _zeros((n, cfg.d_out), F32, dev)), {"card": 1},
            f"gnn train N={n} E={e}")


def _bst_cell(spec, cfg, shape, dims, knobs, dev):
    params = RS.init_params(cfg, _generator(dev), dev)
    f = cfg.n_context_fields

    def batch(b):
        return RS.BSTBatch(
            item_ids=_zeros((b, cfg.seq_len), I32, dev),
            cat_ids=_zeros((b, cfg.seq_len), I32, dev),
            ctx_ids=_zeros((b * f,), I32, dev),
            ctx_segs=_zeros((b * f,), I32, dev),
            labels=_zeros((b,), I32, dev))

    b = dims["batch"]
    if shape.kind == "train":
        opt = adamw_init(dict(params.named_parameters()))
        return (bst_train_step(cfg, lr=1e-3, device=dev),
                (params, opt, batch(b)), {"card": 1}, f"bst train b={b}")
    if shape.kind == "serve":
        return (bst_serve_step(cfg, device=dev), (params, batch(b)),
                {"card": 1}, f"bst serve b={b}")
    if shape.kind == "retrieval":
        nc = dims["n_candidates"]
        return (bst_retrieval_step(cfg, k=128, device=dev),
                (params, _zeros((1, cfg.seq_len), I32, dev),
                 _zeros((1, cfg.seq_len), I32, dev), _zeros((f,), I32, dev),
                 _zeros((f,), I32, dev), _zeros((nc,), I32, dev)),
                {"card": 1}, f"bst retrieval 1x{nc}")
    raise ValueError(shape.kind)


def _engine_cell(spec, cfg, shape, dims, knobs, dev):
    shape = dataclasses.replace(shape, dims=dims)
    total = knobs.get("n_shards", ENGINE_SHARDS)
    mesh = D.make_mesh(total, device=dev)
    per = dims["n_pairs"] // total
    rows = knobs.get("block_rows", per)
    col, cnt = (total, rows), (total,)
    if shape.name.startswith("build"):
        args = tuple(_zeros(s, I32, dev) for s in (col, col, col, cnt) * 2)
        return (engine_build_step(spec, shape, mesh), args, mesh.shape,
                f"engine level join {dims['n_pairs']} pairs on {total} "
                f"in-process shards")
    lc = dims["lookup_classes"]
    args = tuple(_zeros(s, I32, dev) for s in ((lc,), (lc,), col, col, col,
                                                 cnt))
    return (engine_query_step(spec, shape, mesh), args, mesh.shape,
            f"engine conjunction query {dims['n_pairs']} pairs on {total} "
            f"in-process shards")
