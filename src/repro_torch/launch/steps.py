"""Train steps of the port.

:func:`gnn_step` is the concrete counterpart of the step that the
reference's ``launch/steps.py`` ``gnn_cell`` lowers: the masked loss,
its gradients, one ``adamw_update`` — eager, on the card.
"""

from __future__ import annotations

import torch

from ..models import gnn as G
from ..train.optim import AdamWState, adamw_update


def gnn_step(cfg: G.GNNConfig, lr: float = 1e-3, device=None):
    """``step(params, opt_state, g, targets) -> (params, opt_state,
    metrics)`` for ``cfg`` on the CUDA card unless ``device`` names
    another; ``params`` (a ``models.gnn.Params`` module) is updated in
    place and returned, ``metrics`` holds ``loss``, ``grad_norm`` and
    ``clip_scale``.  Inputs on any other device are refused."""
    from ..core.index import resolve_device

    dev = resolve_device(device)

    def step(params, opt_state: AdamWState, g: G.GraphBatch,
             targets: torch.Tensor):
        named = dict(params.named_parameters())
        for what, t in (("params", next(iter(named.values()))),
                        ("graph", g.node_feat), ("targets", targets)):
            if t.device != dev:
                raise ValueError(f"the step runs on {dev}; its {what} lie "
                                 f"on {t.device}")
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
