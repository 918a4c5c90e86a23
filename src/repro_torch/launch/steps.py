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
"""

from __future__ import annotations

import torch

from ..core import distributed as D
from ..core.index import resolve_device
from ..models import gnn as G
from ..models import recsys as RS
from ..models import transformer as T
from ..train.optim import AdamWState, adamw_update

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
