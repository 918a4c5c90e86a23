"""Gradient compression for slow or contended interconnects: blockwise
int8 quantization with error feedback (EF-SGD style), and an all-reduce
that moves int8 over the wire — the reference's ``repro/train/compress.py``
over the port's trees of tensors.

Semantics: quantize(g + residual) -> all_reduce int8 blocks (summed from
each peer's own scale) -> dequantize; the quantization error is carried
to the next step.  ``_quantize`` and ``_dequantize`` are the reference's
arithmetic bit for bit, on the CPU and on the card: ``torch.round``
rounds half to even as ``jnp.round`` does, and every division is the
IEEE float32 quotient (``_over``).

:func:`compressed_psum_grads` runs over a
``core.distributed.InProcessExchange``: each leaf holds the gradients of
the exchange's ``n`` shards folded into a leading dimension of ``n``, as
the sharded engine folds shards into lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .optim import tree_leaves, tree_map, tree_unflatten

BLOCK = 256


class CompressState(NamedTuple):
    residual: dict  # error-feedback carry, same tree as grads (float32)


def compress_init(grads_like) -> CompressState:
    return CompressState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


def _quantize(x: torch.Tensor):
    """Blockwise symmetric int8: returns (q int8 (n/B, B), scale float32
    (n/B, 1), n)."""
    flat = x.to(torch.float32).reshape(-1)
    n = flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, (-n) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = _over(torch.amax(torch.abs(blocks), dim=1, keepdim=True), 127.0) \
        + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, n


def _over(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d``, the IEEE quotient on every device: divided by a 0-d
    tensor beside ``x``, since on CUDA PyTorch multiplies by the
    reciprocal of a Python number, which can differ in the last bit."""
    return x / x.new_full((), d)


def _dequantize(q, scale, n, shape):
    out = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return out.reshape(shape)


def quantize_with_feedback(g: torch.Tensor, residual: torch.Tensor):
    """Returns ((q, scale, n), new_residual)."""
    target = g.to(torch.float32) + residual
    q, scale, n = _quantize(target)
    approx = _dequantize(q, scale, n, g.shape)
    return (q, scale, n), target - approx


def compressed_psum_grads(grads, state: CompressState, exchange):
    """The int8 all-reduce of a gradient tree over ``exchange``'s shards
    with error feedback.  Each leaf is ``(n, *shape)``: row ``s`` shard
    ``s``'s gradient.  Returns (mean grads float32 — every row the same
    mean —, new state).

    Per shard, as in the reference:
      1. quantize(g + residual) — int8 blocks and float32 block scales;
      2. all_to_all the blocks: each shard receives its owned slice from
         every peer (int8 on the wire) with the peers' scales;
      3. reduce the owned slice exactly, each peer's contribution at its
         own scale;
      4. re-quantize the reduced slice, all_gather int8 and scales.

    :func:`wire_bytes` counts what the two legs carry."""
    n_dev = exchange.n_shards

    def shard_quantize(g, r):
        per = [quantize_with_feedback(g[s], r[s]) for s in range(n_dev)]
        q = torch.stack([p[0][0] for p in per])  # (n, nb, BLOCK)
        scale = torch.stack([p[0][1] for p in per])  # (n, nb, 1)
        return q, scale, per[0][0][2], torch.stack([p[1] for p in per])

    def one(g, r):
        q, scale, numel, new_r = shard_quantize(g, r)
        pad = (-q.shape[1]) % n_dev
        if pad:
            q = torch.cat([q, q.new_zeros((n_dev, pad, BLOCK))], 1)
            scale = torch.cat([scale, scale.new_ones((n_dev, pad, 1))], 1)
        m = q.shape[1] // n_dev
        # 2. reduce-scatter leg: int8 on the wire; (n, n peers, m, ...)
        q_rs = exchange.all_to_all(q.reshape(n_dev, n_dev, m, BLOCK))
        s_rs = exchange.all_to_all(scale.reshape(n_dev, n_dev, m, 1))
        # 3. exact per-peer dequantized reduction of each shard's slice
        part = torch.sum(q_rs.to(torch.float32) * s_rs, dim=1)  # (n, m, B)
        # 4. re-quantize the reduced slice; all_gather int8
        s_out = _over(torch.amax(torch.abs(part), dim=2, keepdim=True),
                      127.0) + 1e-12
        q_out = torch.clamp(torch.round(part / s_out), -127, 127).to(
            torch.int8)
        q_full = exchange.all_gather(q_out).reshape(n_dev, n_dev * m, BLOCK)
        s_full = exchange.all_gather(s_out).reshape(n_dev, n_dev * m, 1)
        total = (q_full.to(torch.float32) * s_full).reshape(n_dev, -1)[:, :numel]
        return _over(total, n_dev).reshape(g.shape), new_r

    pairs = [one(g, r) for g, r in zip(tree_leaves(grads),
                                       tree_leaves(state.residual))]
    return (tree_unflatten(grads, [p[0] for p in pairs]),
            CompressState(tree_unflatten(grads, [p[1] for p in pairs])))


def wire_bytes(grads_like, n_shards: int) -> tuple:
    """(bytes, values) one shard's two legs of :func:`compressed_psum_grads`
    carry for a tree like ``grads_like`` (one shard's leaves, unfolded):
    int8 blocks and float32 scales, padded as the function pads them,
    once through ``all_to_all`` and once through ``all_gather``.  A
    float32 ring all-reduce carries 8 bytes a value (reduce-scatter and
    all-gather, 4 each)."""
    total = values = 0
    for g in tree_leaves(grads_like):
        nb = -(-g.numel() // BLOCK)
        nb += (-nb) % n_shards
        total += 2 * nb * (BLOCK + 4)
        values += g.numel()
    return total, values
