"""AdamW with decoupled weight decay and global-norm clipping, as pure
functions over trees of tensors — the reference's ``repro/train/optim.py``
formula for formula.

A tree is a nested dict (leaves in sorted key order, as the reference
orders them), list or tuple of tensors, walked as the checkpoint module
walks it; a flat ``dict(named_parameters())`` is one.  Optimizer state
lives in float32 whatever the parameters' dtype.  ``torch.optim.AdamW``
with ``clip_grad_norm_`` is another function (its clip epsilon is 1e-6,
and it reports no metrics), so it is not used."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..checkpoint.checkpoint import _flatten_with_paths, _unflatten


def tree_leaves(tree) -> list:
    return _flatten_with_paths(tree)[1]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in leaf order."""
    return _unflatten(like, leaves)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    cols = [tree_leaves(t) for t in (tree,) + rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)])


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: object
    nu: object


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(f32, params), nu=tree_map(f32, params))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns ``(new_params, new_state, {"grad_norm", "clip_scale"})``;
    the new parameters are fresh tensors at the parameters' dtype."""
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(g, m, v, p):
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = [upd(*xs) for xs in zip(tree_leaves(grads), tree_leaves(state.mu),
                                   tree_leaves(state.nu), tree_leaves(params))]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_mu = tree_unflatten(state.mu, [o[1] for o in out])
    new_nu = tree_unflatten(state.nu, [o[2] for o in out])
    return new_params, AdamWState(step, new_mu, new_nu), {
        "grad_norm": gnorm, "clip_scale": scale,
    }
