"""Steps of the port: the concrete counterparts of the step functions that
the reference's ``launch/steps.py`` cells lower, eager, on the card.

- :func:`gnn_step` — ``gnn_cell``'s train step: the masked loss, its
  gradients, one ``adamw_update``;
- :func:`lm_prefill_step`, :func:`lm_decode_step` — ``lm_cell``'s
  ``prefill`` and ``decode`` kinds (``transformer.prefill`` /
  ``decode_step``; the cache is written in place, where the cells donate
  it);
- :func:`bst_serve_step`, :func:`bst_retrieval_step` — ``bst_cell``'s
  ``serve`` and ``retrieval`` kinds (``recsys.forward`` /
  ``retrieval_topk`` at k = 128).

Each runs on the CUDA card unless ``device`` names another, and refuses
inputs that lie elsewhere.
"""

from __future__ import annotations

import torch

from ..core.index import resolve_device
from ..models import gnn as G
from ..models import recsys as RS
from ..models import transformer as T
from ..train.optim import AdamWState, adamw_update


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
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()), allow_unused=True,
            materialize_grads=True)))
        new, new_opt, om = adamw_update(grads, opt_state, named, lr=lr)
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(new[name])
        return params, new_opt, {"loss": loss.detach(), **om}

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
