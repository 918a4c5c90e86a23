"""Shared LM building blocks of the port: norms, RoPE, GQA attention (full /
sliding / softcap, and a query-chunked form for long prefill), gated MLPs,
and sort-based top-k MoE dispatch.

Counterpart of the reference's ``repro/models/layers.py``, function for
function.  The reference computes all of it with XLA ops (einsums, a
stable sort, gathers, ``segment_sum``) and reaches no Pallas kernel; the
port computes the same functions with PyTorch tensor ops (``einsum``,
``torch.sort(stable=True)``, indexing, ``index_add_``).

Dtype policy as in the reference: weights in the config's dtype, the
softmax, norms and router in float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------- #
# norms
# ---------------------------------------------------------------------- #


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             gemma_style: bool = False) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = weight.float()
    out = xf * (1.0 + w) if gemma_style else xf * w
    return out.to(dt)


# ---------------------------------------------------------------------- #
# rotary position embedding
# ---------------------------------------------------------------------- #


@functools.lru_cache(maxsize=8)
def _rope_host(head_dim: int, max_len: int, theta: float) -> tuple:
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv)
    return (torch.from_numpy(np.cos(freqs).astype(np.float32)),
            torch.from_numpy(np.sin(freqs).astype(np.float32)))


@functools.lru_cache(maxsize=8)
def _rope_on(head_dim: int, max_len: int, theta: float,
             device: torch.device) -> tuple:
    cos, sin = _rope_host(head_dim, max_len, theta)
    return cos.to(device), sin.to(device)


def rope_table(head_dim: int, max_len: int, theta: float,
               device=None) -> tuple:
    """(cos, sin) tables of shape (max_len, head_dim // 2), float32, on
    ``device`` (the CPU by default): the reference's float64 numpy
    formula, rounded once to float32.  Built once per (head_dim, max_len,
    theta) on the host and once per device: at gemma2's max_len of
    524 352 the float64 outer product alone is 537 MB."""
    return _rope_on(head_dim, max_len, float(theta),
                    torch.device(device if device is not None else "cpu"))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    dt = x.dtype
    c = cos[positions][..., None, :]  # (..., S, 1, D/2)
    s = sin[positions][..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #

NEG = torch.finfo(torch.float32).min


def _softcap(logits: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


def causal_mask(s_q: int, s_kv: int, window: Optional[int] = None,
                q_offset: int = 0, device=None) -> torch.Tensor:
    """(s_q, s_kv) bool mask.  ``window``: sliding-window width (local
    attention); ``q_offset``: absolute position of query row 0."""
    qpos = torch.arange(s_q, device=device)[:, None] + q_offset
    kpos = torch.arange(s_kv, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def gqa_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    mask: torch.Tensor,  # broadcastable to (B, H, S, T) — bool
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention; float32 softmax accumulation."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    groups = h // kv
    qg = q.reshape(b, s, kv, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    logits = _softcap(logits, softcap)
    if mask.ndim == 2:  # (S, T) shared across batch/heads
        m = mask[None, None, None]
    elif mask.ndim == 3:  # (B, S, T) per-example (e.g. decode lengths)
        m = mask[:, None, None]
    else:
        raise ValueError(f"mask ndim {mask.ndim} unsupported")
    logits = torch.where(m, logits, NEG)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v)
    return out.reshape(b, s, h, d)


def chunked_gqa_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    qpos: torch.Tensor,  # (S,) absolute query positions
    kpos: torch.Tensor,  # (T,) absolute key positions
    window,  # int or 0-d tensor: window size (> T means global)
    scale: float,
    softcap: Optional[float],
    q_chunk: int,
) -> torch.Tensor:
    """Query-chunked attention for long sequences (32k+ prefill): a loop
    over S/q_chunk query blocks, so the logits working set is
    (B, H, q_chunk, T) instead of (B, H, S, T); the (S, T) mask is never
    materialized either (membership from positions, a block at a time).
    Numerics identical to :func:`gqa_attention` (masked float32
    softmax)."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    assert s % q_chunk == 0, (s, q_chunk)
    qg = q.reshape(b, s, kv, g, d)
    out = torch.empty_like(q)
    for i in range(s // q_chunk):
        lo, hi = i * q_chunk, (i + 1) * q_chunk
        logits = torch.einsum("bskgd,btkd->bkgst", qg[:, lo:hi], k).float()
        logits = _softcap(logits * scale, softcap)
        qp = qpos[lo:hi]
        mask = (kpos[None, :] <= qp[:, None]) & (kpos[None, :] > qp[:, None] - window)
        logits = torch.where(mask[None, None, None], logits, NEG)
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        out[:, lo:hi] = torch.einsum("bkgst,btkd->bskgd", p, v).reshape(
            b, q_chunk, h, d)
        del logits, p
    return out


# ---------------------------------------------------------------------- #
# gated MLP
# ---------------------------------------------------------------------- #


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    h = _act(activation)(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ---------------------------------------------------------------------- #
# sort-based top-k MoE (dropping, GShard-equivalent capacity semantics)
# ---------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class MoEDims:
    n_experts: int
    top_k: int
    capacity: int  # per expert per group (static)


def moe_capacity(tokens_per_group: int, top_k: int, n_experts: int,
                 capacity_factor: float) -> int:
    c = int(np.ceil(tokens_per_group * top_k * capacity_factor / n_experts))
    return max(1, c)


def _one_hot(ids: torch.Tensor, classes: torch.Tensor, dtype) -> torch.Tensor:
    """``F.one_hot(ids, len(classes))`` in ``dtype``, without the host
    round trip that ``one_hot`` and ``bincount`` make on a card to check
    their ids."""
    return (ids[..., None] == classes).to(dtype)


def _topk_gates(probs: torch.Tensor, k: int):
    """Iterative top-k (argmax + mask, k small), as the reference: ties go
    to the first index; an expert once picked is never picked again."""
    experts = torch.arange(probs.shape[-1], device=probs.device)
    p = probs
    gis, gvs = [], []
    for _ in range(k):
        gi = torch.argmax(p, dim=-1)
        onehot = _one_hot(gi, experts, probs.dtype)
        gvs.append(torch.sum(probs * onehot, dim=-1))
        gis.append(gi.to(torch.int32))
        p = p * (1 - onehot) - onehot  # never re-picked
    return torch.stack(gvs, -1), torch.stack(gis, -1)


def moe_ffn(
    x: torch.Tensor,  # (G, S, D) tokens, one group a sequence
    router_w: torch.Tensor,  # (D, E)
    w_gate: torch.Tensor,  # (E, D, F)
    w_up: torch.Tensor,  # (E, D, F)
    w_down: torch.Tensor,  # (E, F, D)
    dims: MoEDims,
    activation: str = "silu",
):
    """Token-dropping top-k MoE with group-local dispatch, as the
    reference: the (group, expert) assignments are ordered by ONE stable
    sort on the composite key ``group*E + expert``; the (G, E, C, D)
    expert buffers are built by gathers, position-in-expert falling out
    of the sorted order, so an assignment past its expert's capacity C is
    dropped in that order; the combine sums each buffer row back to its
    token, dropped rows into a trash segment.

    Returns (y (G, S, D), aux) with the load-balancing loss and the
    dropped share of the assignments."""
    g, s, d = x.shape
    e, k, c = dims.n_experts, dims.top_k, dims.capacity
    n = g * s * k  # total routed assignments
    dt, dev = x.dtype, x.device

    logits = x.float() @ router_w.float()  # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _topk_gates(probs, k)  # (G,S,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # ---- flat assignment lists ------------------------------------------ #
    flat_e = expert_idx.reshape(n).long()
    ar = torch.arange(n, device=dev)
    g_of = ar // (s * k)
    tok_global = g_of * s + (ar % (s * k)) // k
    flat_gate = gate_vals.reshape(n)
    kcomp = g_of * e + flat_e  # group-major composite key, in [0, G*E)
    sidx = torch.sort(kcomp, stable=True).indices
    sizes = torch.zeros(g * e, dtype=torch.int64, device=dev).index_add_(
        0, kcomp, torch.ones_like(kcomp))  # (G*E,)
    offs = torch.cumsum(sizes, 0) - sizes

    # ---- expert buffers via pure gather ---------------------------------- #
    r = torch.arange(g * e * c, device=dev)
    ge, p = r // c, r % c
    src = offs[ge] + p
    valid = p < sizes[ge]
    assign = sidx[torch.clamp(src, 0, n - 1)]  # original assignment index
    tok = tok_global[assign]  # global token id (G*S)
    xb = x.reshape(g * s, d)[tok]  # (G*E*C, D)
    xb = torch.where(valid[:, None], xb, 0).reshape(g, e, c, d)

    # ---- expert computation (the only real FLOPs) ------------------------ #
    hg = torch.einsum("gecd,edf->gecf", xb, w_gate.to(dt))
    hu = torch.einsum("gecd,edf->gecf", xb, w_up.to(dt))
    yb = torch.einsum("gecf,efd->gecd", _act(activation)(hg) * hu,
                      w_down.to(dt))
    yb = yb.reshape(g * e * c, d)

    # ---- combine: flat segment-sum back to tokens ------------------------- #
    gates_b = flat_gate[assign]  # (G*E*C,)
    contrib = yb * (gates_b * valid.float()).to(dt)[:, None]
    seg = torch.where(valid, tok, g * s)  # dropped -> trash segment
    y = torch.zeros(g * s + 1, d, dtype=dt, device=dev).index_add_(
        0, seg, contrib)[: g * s].reshape(g, s, d)

    # ---- aux: load-balancing loss (Switch-style) ------------------------ #
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    ce = torch.mean(_one_hot(expert_idx[..., 0], torch.arange(e, device=dev),
                             torch.float32), dim=(0, 1))
    aux_loss = e * torch.sum(me * ce)
    kept = torch.sum(valid.float())  # routed assignments kept
    dropped = 1.0 - kept / (g * s * k)
    return y.to(dt), {"moe_aux_loss": aux_loss, "moe_dropped_frac": dropped}


# ---------------------------------------------------------------------- #
# init helpers
# ---------------------------------------------------------------------- #


def normal_init(generator: torch.Generator, shape, dtype, scale: float = 1.0,
                device=None) -> torch.Tensor:
    """normal * scale / sqrt(fan_in), fan_in = ``shape[-2]`` (so an (V, d)
    embedding is drawn with std 1/sqrt(V), as the reference draws it):
    drawn in float32 on the generator's device, then cast to ``dtype`` on
    ``device`` (the generator's by default).  On the ``meta`` device
    nothing is drawn or allocated."""
    device = torch.device(device) if device is not None else generator.device
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device) * std
    return x.to(device, dtype)
