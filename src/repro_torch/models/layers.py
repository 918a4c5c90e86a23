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

On a mesh the tensors are DTensors (``launch.shardings`` lays them out).
Each ``with_sharding_constraint`` of the reference is :func:`constrain`,
a ``redistribute`` of a DTensor and a no-op on a plain tensor; the
helpers below it pin the layouts DTensor's own propagation would not
choose as GSPMD does (``PERF.md`` lists every such place): activations
batch-sharded (:func:`pin_batch`), weights gathered over their FSDP axes
before use (:func:`tp_only`), a softmax over a sharded last dimension
taken in parts (:func:`softmax_last`), and the MoE's routing (a stable
sort, gathers, ``index_add_``) run on each rank's own groups.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# ---------------------------------------------------------------------- #
# mesh layouts (DTensor): each a no-op on a plain tensor
# ---------------------------------------------------------------------- #


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _placements(spec, mesh) -> list:
    from ..launch.shardings import placements

    return placements(spec, mesh)


def _names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def constrain(x, spec):
    """The reference's ``with_sharding_constraint(x, P(*spec))``: a
    DTensor redistributed to ``spec`` on its own mesh; a plain tensor as
    it is."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, _placements(spec, x.device_mesh))


def batch_spec(x) -> tuple:
    """A spec of ``x``'s rank sharding its leading (batch) dimension over
    the mesh's non-"model" axes, as many of them (the minor ones kept) as
    divide it; the rest replicated."""
    mesh = x.device_mesh
    axes = tuple(a for a in _names(mesh) if a != "model")
    while axes and x.shape[0] % math.prod(
            mesh.size(_names(mesh).index(a)) for a in axes):
        axes = axes[1:]
    return (spec_entry(axes),) + (None,) * (x.ndim - 1)


def pin_batch(x):
    """Activations at a block boundary: the batch over the batch axes,
    every other dimension whole on each rank.  DTensor's own propagation
    may keep a batch replicated where GSPMD splits it."""
    return constrain(x, batch_spec(x)) if is_dtensor(x) else x


def tp_only(w):
    """A weight gathered over every mesh axis but "model" (the FSDP
    all-gather; its gradient is reduce-scattered back), so a matmul with
    batch-sharded activations needs no other collective."""
    if not is_dtensor(w):
        return w
    names = _names(w.device_mesh)
    want = [p if n == "model" else Replicate()
            for n, p in zip(names, w.placements)]
    return w.redistribute(w.device_mesh, want)


def local_of(x):
    """``x``'s local shard (``x`` itself when plain): differentiable."""
    return x.to_local() if is_dtensor(x) else x


def like(local, ref, placements=None):
    """A local tensor as a DTensor on ``ref``'s mesh with ``ref``'s
    placements (or ``placements``); ``local`` itself when ``ref`` is
    plain.  Differentiable; even shards are assumed."""
    if not is_dtensor(ref):
        return local
    return DTensor.from_local(local, ref.device_mesh,
                              placements or ref.placements, run_check=False)


def replicated(t, ref):
    """A plain tensor ``t`` (a mask, a RoPE slice, an index) that meets
    the DTensor ``ref``: replicated on ``ref``'s mesh; as it is when
    ``ref`` is plain."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    return DTensor.from_local(t, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def same_layout(t, ref):
    """``t`` redistributed to ``ref``'s placements (a partial sum
    reduced, a sharded dimension gathered); as it is when plain."""
    if not is_dtensor(t):
        return t
    return t.redistribute(ref.device_mesh, ref.placements)


def spec_entry(axes):
    """One spec entry from a tuple of axis names (its name when one,
    None when none)."""
    axes = tuple(axes)
    return (axes if len(axes) > 1 else axes[0]) if axes else None


def local_range(x, dim: int) -> tuple:
    """``(start, stop)`` of this rank's slice of the DTensor ``x`` along
    its global dimension ``dim``."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, off = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return off[dim], off[dim] + shape[dim]


class AxisShards:
    """One tensor axis (the K/V time, the vocabulary) split over some
    mesh dimensions, seen from one rank's local operands: sums and maxima
    over it are taken in parts and all-reduced over those dimensions, as
    GSPMD partitions a reduction over a sharded axis (for attention,
    flash-decoding's combine).  The collectives are DTensor redistributes
    from ``Partial``, so autograd carries them: each rank's gradient of an
    all-reduced sum is the gradient it gets back, which is whole when
    what follows is the same on every rank; where it is not,
    :meth:`summed_grad` all-reduces it."""

    def __init__(self, mesh, dims):
        self.mesh, self.dims = mesh, tuple(dims)

    def _reduce(self, t, op):
        part = [Partial(op) if i in self.dims else Replicate()
                for i in range(self.mesh.ndim)]
        whole = [Replicate()] * self.mesh.ndim
        return DTensor.from_local(t, self.mesh, part, run_check=False) \
            .redistribute(self.mesh, whole).to_local()

    def max(self, t):
        return self._reduce(t, "max")

    def sum(self, t):
        return self._reduce(t, "sum")

    def summed_grad(self, t):
        """``t`` as it is, its gradient all-reduced over the split: for a
        replicated operand that meets a split one (Megatron's "f")."""
        whole = [Replicate()] * self.mesh.ndim
        part = [Partial() if i in self.dims else Replicate()
                for i in range(self.mesh.ndim)]
        return DTensor.from_local(t, self.mesh, whole, run_check=False) \
            .to_local(grad_placements=part)

    def gathered(self, t, dim: int):
        """Each rank's slice along ``dim``, the slices concatenated in
        mesh order (an all-gather)."""
        part = [Shard(dim) if i in self.dims else Replicate()
                for i in range(self.mesh.ndim)]
        whole = [Replicate()] * self.mesh.ndim
        return DTensor.from_local(t, self.mesh, part, run_check=False) \
            .redistribute(self.mesh, whole).to_local()

    def softmax(self, logits):
        """The sum meets each rank's own part of the axis again: its
        gradient, a part on each rank, is all-reduced too."""
        m = self.max(torch.amax(logits, dim=-1, keepdim=True).detach())
        e = torch.exp(logits - m)
        return e / self.summed_grad(
            self.sum(torch.sum(e, dim=-1, keepdim=True)))


def split_dims(x, dim: int) -> list:
    """The mesh dimensions that split the DTensor ``x``'s ``dim``."""
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def grad_parts(x, placements) -> list:
    """``placements`` with ``Partial`` where ``x``'s own placement is
    ``Replicate`` but a rank's computation with its local copy differs
    along that mesh dimension (another operand is split there): the
    gradient each rank gets back is a part of the whole."""
    return [Partial() if isinstance(p, Replicate) and other else p
            for p, other in zip(x.placements, placements)]


def embedding_on_mesh(table, ids):
    """``table[ids]`` of DTensors: the table (V, D) with its rows over
    some mesh dimensions and its columns whole (an FSDP'd table gathered
    first, ``tp_only``), the ids laid out by their batch.  Each rank looks
    up the ids its rows hold, the rest read as 0, and the parts are
    all-reduced over the row dimensions (the vocabulary-parallel lookup;
    DTensor's own embedding backward makes a whole-vocabulary gradient on
    every rank).  Returns the rows laid out as the ids."""
    mesh = table.device_mesh
    vdims = split_dims(table, 0)
    batch = [Replicate() if i in vdims else p
             for i, p in enumerate(ids.placements)]
    il = ids.redistribute(mesh, batch).to_local().long()
    tl = table.to_local(grad_placements=grad_parts(
        table, [isinstance(p, Shard) for p in batch]))
    v0, v1 = local_range(table, 0)
    mine = (il >= v0) & (il < v1)
    rows = torch.where(mine[..., None], tl[(il - v0).clamp(0, v1 - v0 - 1)],
                       0)
    rows = AxisShards(mesh, vdims).sum(rows)
    return DTensor.from_local(rows, mesh, [
        Shard(p.dim) if isinstance(p, Shard) else Replicate() for p in batch],
        run_check=False)


def log_likelihood_on_mesh(logits, labels):
    """``logits[..., label] - logsumexp(logits)`` a token, the logits
    (B, S, V) a DTensor with the vocabulary over some mesh dimensions:
    the vocabulary-parallel cross entropy (a gather of the label's logit
    would gather the vocabulary, and DTensor's own propagation of the
    reductions leaves strided layouts it plans at great cost).  Returns
    (B, S) laid out as the logits' batch; 0 - logsumexp where the label
    is outside [0, V)."""
    mesh = logits.device_mesh
    vdims = split_dims(logits, 2)
    rows = [Replicate() if i in vdims else p
            for i, p in enumerate(logits.placements)]
    lab = labels.redistribute(mesh, rows).to_local().long()
    lg = logits.to_local()
    v0, v1 = local_range(logits, 2)
    ax = AxisShards(mesh, vdims)
    m = ax.max(torch.amax(lg, dim=-1, keepdim=True).detach())
    lse = torch.log(ax.sum(torch.sum(torch.exp(lg - m), dim=-1))) + m[..., 0]
    mine = (lab >= v0) & (lab < v1)
    picked = torch.gather(lg, -1, (lab - v0).clamp(0, v1 - v0 - 1)[..., None])
    picked = ax.sum(torch.where(mine, picked[..., 0], 0.0))
    return DTensor.from_local(picked - lse, mesh, rows, run_check=False)


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
    if is_dtensor(x):  # per position: on the local rows
        lo, hi = local_range(x, x.ndim - 3)
        positions = positions[..., lo:hi]
        if positions.ndim > 1 and positions.shape[0] == x.shape[0] > 1:
            b0, b1 = local_range(x, 0)
            positions = positions[b0:b1]
        return like(apply_rope(x.to_local(), cos, sin, positions), x)
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
    time_shards: Optional[AxisShards] = None,
) -> torch.Tensor:
    """Grouped-query attention; float32 softmax accumulation.  With
    ``time_shards`` the operands are one rank's and K/V hold its part of
    the time axis."""
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
    if time_shards is None:
        p = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bkgst,btkd->bskgd", p, v)
    else:
        p = time_shards.softmax(logits).to(q.dtype)
        out = time_shards.sum(torch.einsum("bkgst,btkd->bskgd", p, v))
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
    time_shards: Optional[AxisShards] = None,
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
        if time_shards is None:
            p = torch.softmax(logits, dim=-1).to(q.dtype)
            o = torch.einsum("bkgst,btkd->bskgd", p, v)
        else:
            p = time_shards.softmax(logits).to(q.dtype)
            o = time_shards.sum(torch.einsum("bkgst,btkd->bskgd", p, v))
        out[:, lo:hi] = o.reshape(b, q_chunk, h, d)
        del logits, p
    return out


def attention_on_mesh(q, k, v, scale: float, softcap, *, mask=None,
                      qpos=None, kpos=None, window=None, q_chunk: int = 0):
    """:func:`gqa_attention` (``mask``) or :func:`chunked_gqa_attention`
    (``qpos``, ``kpos``, ``window``, ``q_chunk``) of DTensors, run on each
    rank's shards: DTensor's own propagation through the GQA reshapes and
    einsums searches layouts at great cost and may gather the time axis.
    K/V keep their layout (heads over "model", or time over some axes, or
    whole); the queries are laid out to match (replicated where the time
    is split, batch as K/V's, heads or sequence over "model" otherwise);
    masks and positions are cut to the local rows and columns, the kv
    heads to the local query heads' groups, and a split time axis takes
    the softmax in parts (:class:`TimeShards`).  Returns a DTensor laid
    out as the queries."""
    mesh = q.device_mesh
    want_q, want_kv = list(q.placements), list(k.placements)
    time_dims = []
    for i, (qp, kp) in enumerate(zip(q.placements, k.placements)):
        if isinstance(kp, Shard) and kp.dim == 1:  # time split here
            want_q[i] = Replicate()
            time_dims.append(i)
        elif isinstance(kp, Shard):  # batch or kv heads: queries alike
            want_q[i] = kp
        elif isinstance(qp, Shard) and qp.dim == 0:  # batch: K/V alike
            want_kv[i] = qp
    q = q.redistribute(mesh, want_q)
    k, v = k.redistribute(mesh, want_kv), v.redistribute(mesh, want_kv)
    ql = q.to_local(grad_placements=grad_parts(q, [
        isinstance(p, Shard) for p in want_kv]))
    kv_grads = grad_parts(k, [isinstance(p, Shard) for p in want_q])
    kl = k.to_local(grad_placements=kv_grads)
    vl = v.to_local(grad_placements=kv_grads)
    h, kv = q.shape[2], k.shape[2]
    h0, h1 = local_range(q, 2)
    if kl.shape[2] == kv and h1 - h0 < h:  # query heads split, K/V whole
        g = h // kv
        kl = kl[:, :, h0 // g:(h1 - 1) // g + 1]
        vl = vl[:, :, h0 // g:(h1 - 1) // g + 1]
    r0, r1 = local_range(q, 1)
    t0, t1 = local_range(k, 1)
    shards = AxisShards(mesh, time_dims) if time_dims else None
    if q_chunk:
        out = chunked_gqa_attention(ql, kl, vl, qpos[r0:r1], kpos[t0:t1],
                                    window, scale=scale, softcap=softcap,
                                    q_chunk=q_chunk, time_shards=shards)
    else:
        m = mask[..., t0:t1]
        if m.shape[-2] == q.shape[1]:
            m = m[..., r0:r1, :]
        out = gqa_attention(ql, kl, vl, m, scale=scale, softcap=softcap,
                            time_shards=shards)
    return like(out, q)


# ---------------------------------------------------------------------- #
# gated MLP
# ---------------------------------------------------------------------- #


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda t: F.gelu(t, approximate="tanh")}[name]


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    h = _act(activation)(x @ tp_only(w_gate)) * (x @ tp_only(w_up))
    return h @ tp_only(w_down)


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
    c_axes: tuple = (),  # token-TP: the capacity dim over these axes
):
    """Token-dropping top-k MoE with group-local dispatch, as the
    reference: the (group, expert) assignments are ordered by ONE stable
    sort on the composite key ``group*E + expert``; the (G, E, C, D)
    expert buffers are built by gathers, position-in-expert falling out
    of the sorted order, so an assignment past its expert's capacity C is
    dropped in that order; the combine sums each buffer row back to its
    token, dropped rows into a trash segment.

    On a mesh (``x`` a DTensor, its groups over the batch axes) all of it
    runs on each rank's own groups (dispatch is group-local): the expert
    einsums with the local shards of the expert weights (d_ff over
    "model": partial sums, all-reduced), or with ``c_axes`` each rank's
    slice of the buffers' capacity dimension (the reference's token-TP
    constraint) against whole experts, the slices then all-gathered.

    Returns (y (G, S, D), aux) with the load-balancing loss and the
    dropped share of the assignments."""
    g, s, d = x.shape
    e, k, c = dims.n_experts, dims.top_k, dims.capacity
    dt, dev = x.dtype, x.device
    wr, wg, wu, wd = (tp_only(w) for w in (router_w, w_gate, w_up, w_down))
    rows = None  # the batch axes, over which the aux statistics sum
    if is_dtensor(x):
        mesh = x.device_mesh
        batch = [isinstance(p, Shard) for p in x.placements]
        rows = AxisShards(mesh, [i for i, b in enumerate(batch) if b])
        f_dims = split_dims(wg, 2)
        # replicated over the batch axes: their gradients are partial sums
        wr, wg, wu, wd = (w.to_local(grad_placements=grad_parts(w, batch))
                          for w in (wr, wg, wu, wd))
    xl = local_of(x)  # this rank's groups
    gl = xl.shape[0]
    n = gl * s * k  # routed assignments of those groups

    logits = xl.float() @ wr.float()  # (Gl,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _topk_gates(probs, k)  # (Gl,S,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # ---- flat assignment lists ------------------------------------------ #
    flat_e = expert_idx.reshape(n).long()
    ar = torch.arange(n, device=dev)
    g_of = ar // (s * k)
    tok_global = g_of * s + (ar % (s * k)) // k
    flat_gate = gate_vals.reshape(n)
    kcomp = g_of * e + flat_e  # group-major composite key, in [0, Gl*E)
    sidx = torch.sort(kcomp, stable=True).indices
    sizes = torch.zeros(gl * e, dtype=torch.int64, device=dev).index_add_(
        0, kcomp, torch.ones_like(kcomp))  # (Gl*E,)
    offs = torch.cumsum(sizes, 0) - sizes

    # ---- expert buffers via pure gather ---------------------------------- #
    r = torch.arange(gl * e * c, device=dev)
    ge, p = r // c, r % c
    src = offs[ge] + p
    valid = p < sizes[ge]
    assign = sidx[torch.clamp(src, 0, n - 1)]  # original assignment index
    tok = tok_global[assign]  # token id among this rank's (Gl*S)
    xb = xl.reshape(gl * s, d)[tok]  # (Gl*E*C, D)
    xb = torch.where(valid[:, None], xb, 0).reshape(gl, e, c, d)

    # ---- expert computation (the only real FLOPs) ------------------------ #
    if rows is not None:
        if c_axes:  # this rank's capacity slots against whole experts
            cut = AxisShards(mesh, [_names(mesh).index(a) for a in c_axes])
            xb = cut.summed_grad(xb)
            n_c = math.prod(mesh.size(i) for i in cut.dims)
            at = sum(mesh.get_local_rank(i) * math.prod(
                mesh.size(j) for j in cut.dims if j > i) for i in cut.dims)
            xb = xb[:, :, at * (c // n_c):(at + 1) * (c // n_c)]
        else:  # d_ff over "model": the buffers meet every shard
            cut = AxisShards(mesh, f_dims)
            xb = cut.summed_grad(xb)
    hg = torch.einsum("gecd,edf->gecf", xb, wg.to(dt))
    hu = torch.einsum("gecd,edf->gecf", xb, wu.to(dt))
    yb = torch.einsum("gecf,efd->gecd", _act(activation)(hg) * hu, wd.to(dt))
    if rows is not None:
        yb = cut.gathered(yb, 2) if c_axes else cut.sum(yb)
    yb = yb.reshape(gl * e * c, d)

    # ---- combine: flat segment-sum back to tokens ------------------------- #
    gates_b = flat_gate[assign]  # (Gl*E*C,)
    contrib = yb * (gates_b * valid.float()).to(dt)[:, None]
    seg = torch.where(valid, tok, gl * s)  # dropped -> trash segment
    y = torch.zeros(gl * s + 1, d, dtype=dt, device=dev).index_add_(
        0, seg, contrib)[: gl * s].reshape(gl, s, d)

    # ---- aux: load-balancing loss (Switch-style) ------------------------ #
    first = _one_hot(expert_idx[..., 0], torch.arange(e, device=dev),
                     torch.float32)
    if rows is None:
        me = torch.mean(probs, dim=(0, 1))  # (E,)
        ce = torch.mean(first, dim=(0, 1))
        kept = torch.sum(valid.float())  # routed assignments kept
    else:  # over every rank's groups
        me = rows.sum(torch.sum(probs, dim=(0, 1))) / (g * s)
        ce = rows.sum(torch.sum(first, dim=(0, 1))) / (g * s)
        kept = rows.sum(torch.sum(valid.float()))
    aux_loss = e * torch.sum(me * ce)
    dropped = 1.0 - kept / (g * s * k)
    whole = [Replicate()] * x.device_mesh.ndim if rows is not None else None
    return like(y.to(dt), x), {"moe_aux_loss": like(aux_loss, x, whole),
                               "moe_dropped_frac": like(dropped, x, whole)}


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
