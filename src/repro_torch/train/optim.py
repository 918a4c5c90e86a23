"""AdamW with decoupled weight decay and global-norm clipping, as pure
functions over trees of tensors — the reference's ``repro/train/optim.py``
formula for formula.

A tree is a nested dict (leaves in sorted key order, as the reference
orders them), list or tuple of tensors, walked as the checkpoint module
walks it; a flat ``dict(named_parameters())`` is one.  Optimizer state
lives in float32 whatever the parameters' dtype.  ``torch.optim.AdamW``
with ``clip_grad_norm_`` is another function (its clip epsilon is 1e-6,
and it reports no metrics), so it is not used.

On a mesh the leaves are DTensors: each gradient is first laid out like
its parameter (a partial sum reduced), the clip reads the *global* norm
(every rank clips by the same scale), and the update, elementwise, runs
on each rank's local shards (a flat view of a sharded DTensor is not
expressible, so the in-place slices stay local)."""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

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


INPLACE_CHUNK = 1 << 24  # elements an in-place update slice holds


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: object
    nu: object


def adamw_init(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None

    def f32(p):  # a DTensor's moments keep its placements
        return torch.zeros_like(p, dtype=torch.float32,
                                memory_format=torch.contiguous_format)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(f32, params), nu=tree_map(f32, params))


def global_norm(tree) -> torch.Tensor:
    """The norm of every leaf together; over DTensor leaves the global
    one (a plain tensor, the same on every rank)."""
    norm = torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))
    return norm.full_tensor() if isinstance(norm, DTensor) else norm


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _laid_out_like(g, p):
    """A DTensor gradient in its parameter's placements."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 inplace: bool = False):
    """Returns ``(new_params, new_state, {"grad_norm", "clip_scale"})``;
    the new parameters are fresh tensors at the parameters' dtype.  With
    ``inplace`` the new moments and parameters are written into the given
    tensors (what the reference's cells get by donating them), a slice of
    at most ``INPLACE_CHUNK`` elements at a time, so the update holds no
    second copy of the state; the values are the same, and the returned
    trees are ``params`` and ``state``'s own."""
    grads = tree_unflatten(grads, [
        _laid_out_like(g, p)
        for g, p in zip(tree_leaves(grads), tree_leaves(params))])
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

    leaves = zip(*(map(_local, tree_leaves(t))
                   for t in (grads, state.mu, state.nu, params)))
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    if inplace:  # elementwise: slices of flat views give the same values
        for g, m, v, p in leaves:
            g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
            for i in range(0, p.numel(), INPLACE_CHUNK):
                sl = slice(i, i + INPLACE_CHUNK)
                new_p, new_m, new_v = upd(g[sl], m[sl], v[sl], p[sl])
                m[sl], v[sl], p[sl] = new_m, new_v, new_p
        return params, AdamWState(step, state.mu, state.nu), metrics
    out = [upd(*xs) for xs in leaves]

    def rewrap(tree, i):  # local results as DTensors where the leaves were
        return tree_unflatten(tree, [
            DTensor.from_local(o[i], t.device_mesh, t.placements,
                               run_check=False)
            if isinstance(t, DTensor) else o[i]
            for o, t in zip(out, tree_leaves(tree))])

    new_params = rewrap(params, 0)
    new_mu = rewrap(state.mu, 1)
    new_nu = rewrap(state.nu, 2)
    return new_params, AdamWState(step, new_mu, new_nu), metrics
