"""BST — Behavior Sequence Transformer (Alibaba) [arXiv:1905.06874], in the
port.

    item/category embeddings + learned positions over a length-20 behavior
    sequence (target item appended) -> 1 transformer block (8 heads)
    -> concat with user/context EmbeddingBag features -> MLP 1024-512-256
    -> logit.

Counterpart of the reference's ``repro/models/recsys.py``, function for
function and with the same parameter names.  The reference's
EmbeddingBag is ``take`` + ``segment_sum``; here it is indexing +
``index_add_``.  The reference stacks the blocks' leaves on a leading
``n_blocks`` axis; here ``params["blocks"]`` is an ``nn.ModuleList``
(``convert.bst_params_from_numpy`` / ``bst_params_to_numpy`` carry a
tree across).

Shapes (``configs.recsys_shapes``): train_batch B=65 536, serve_p99
B=512, serve_bulk B=262 144, retrieval_cand B=1 over 1 M candidates (the
sequence tower runs once, the candidates are scored by one batched dot,
then top-k).

On a mesh (``launch.shardings.bst_param_specs``: the tables' rows over
"model", the dense layers replicated; the batch over the other axes) the
lookups are vocabulary-parallel (``layers.embedding_on_mesh``: each
rank reads the ids its rows hold, the parts all-reduced), the
EmbeddingBag's ``index_add_`` runs on each rank's ids into every
segment and the partial sums are reduce-scattered to the batch layout,
and the block and the MLP, per example, run on each rank's own rows with
the replicated weights (whose gradients are then partial sums over the
batch axes).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Shard

from . import layers as L
from .gnn import Params


@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 4_000_000  # sparse table rows (Alibaba-scale surrogate)
    n_cats: int = 100_000
    n_context: int = 1_000_000  # multi-hot context vocab (user profile etc.)
    embed_dim: int = 32
    seq_len: int = 20  # behavior sequence incl. target slot
    n_heads: int = 8
    n_blocks: int = 1
    d_ff: int = 128
    mlp_dims: tuple = (1024, 512, 256)
    n_context_fields: int = 8  # avg multi-hot ids per example
    param_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


class BSTBatch(NamedTuple):
    """One ranking batch (numpy arrays from ``data.recsys_stream``, or
    tensors on a device).

    item_ids   (B, S)  behavior sequence, target at slot S-1
    cat_ids    (B, S)
    ctx_ids    (B*F,)  flattened multi-hot context ids
    ctx_segs   (B*F,)  example id per context id (EmbeddingBag segments)
    labels     (B,)    click labels (train only)
    """

    item_ids: object
    cat_ids: object
    ctx_ids: object
    ctx_segs: object
    labels: object


def init_params(cfg: BSTConfig, generator: torch.Generator,
                device=None) -> Params:
    """Fresh parameters of ``cfg`` on the CUDA card unless ``device``
    names another, drawn from ``generator`` (float32 on its device, then
    cast) as the reference draws from its key: embeddings normal * 0.01,
    weights normal / sqrt(fan_in), layer-norm weights 1, biases 0.  The
    same distributions, not the same draws.  ``device="meta"`` builds the
    tree without drawing or allocating."""
    from ..core.index import resolve_device

    dev = resolve_device(device)
    dt = cfg.dtype
    d = cfg.embed_dim

    def normal(shape, std):
        if dev.type == "meta":
            return torch.empty(shape, dtype=dt, device=dev)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(dev, dt)

    def emb(n, dim):
        return normal((n, dim), 0.01)

    def lin(i, o):
        return normal((i, o), 1.0 / math.sqrt(i))

    def const(n, value):
        return torch.full((n,), value, dtype=dt, device=dev)

    dm = 2 * d  # item ⊕ category per position
    blocks = nn.ModuleList(
        Params(wq=lin(dm, dm), wk=lin(dm, dm), wv=lin(dm, dm), wo=lin(dm, dm),
               ff1=lin(dm, cfg.d_ff), ff2=lin(cfg.d_ff, dm),
               ln1=const(dm, 1.0), ln2=const(dm, 1.0))
        for _ in range(cfg.n_blocks))
    mlp_in = cfg.seq_len * dm + d  # flattened sequence + context bag
    dims = (mlp_in,) + tuple(cfg.mlp_dims) + (1,)
    mlp = {f"w{i}": lin(dims[i], dims[i + 1]) for i in range(len(dims) - 1)}
    mlp |= {f"b{i}": const(dims[i + 1], 0.0) for i in range(len(dims) - 1)}
    return Params(item_emb=emb(cfg.n_items, d), cat_emb=emb(cfg.n_cats, d),
                  ctx_emb=emb(cfg.n_context, d),
                  pos_emb=emb(cfg.seq_len, dm), blocks=blocks,
                  mlp=Params(**mlp))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, segs: torch.Tensor,
                  n_segments: int, mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag as gather + ``index_add_`` over unsorted segments; a
    segment id outside [0, n_segments) is dropped, as ``segment_sum``
    drops it.  ``mode="mean"`` divides by max(count, 1)."""
    if L.is_dtensor(table):
        return _embedding_bag_on_mesh(table, ids, segs, n_segments, mode)
    rows = table[ids]
    segs = segs.long()
    spare = torch.where((segs >= 0) & (segs < n_segments), segs, n_segments)
    out = torch.zeros((n_segments + 1, table.shape[1]), dtype=table.dtype,
                      device=table.device).index_add_(0, spare, rows)
    out = out[:n_segments]
    if mode == "mean":
        cnt = torch.zeros(n_segments + 1, dtype=table.dtype,
                          device=table.device).index_add_(
            0, spare, torch.ones_like(ids, dtype=table.dtype))[:n_segments]
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _lookup(table, ids):
    """``table[ids]``; on a mesh the vocabulary-parallel lookup
    (``layers.embedding_on_mesh``), pinned to the ids' batch layout."""
    if not L.is_dtensor(table):
        return table[ids]
    return L.pin_batch(L.embedding_on_mesh(table, ids))


def _embedding_bag_on_mesh(table, ids, segs, n_segments, mode):
    rows = _lookup(table, ids)  # (N, d), N over the batch axes
    mesh = rows.device_mesh
    seg_l = segs.redistribute(mesh, rows.placements[:]).to_local().long() \
        if L.is_dtensor(segs) else segs.long()
    rl = rows.to_local()
    spare = torch.where((seg_l >= 0) & (seg_l < n_segments), seg_l,
                        n_segments)
    part = [Partial() if isinstance(p, Shard) else p
            for p in rows.placements]

    def summed(values):  # every segment's partial sum, then reduced
        out = torch.zeros((n_segments + 1,) + values.shape[1:],
                          dtype=values.dtype, device=values.device)
        out = out.index_add_(0, spare, values)[:n_segments]
        whole = DTensor.from_local(out, mesh, part, run_check=False)
        return L.pin_batch(whole)

    out = summed(rl)
    if mode == "mean":
        cnt = summed(torch.ones(rl.shape[:1], dtype=rl.dtype,
                                device=rl.device))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _on_rows(fn, x, *weights):
    """``fn(x, *weights)`` per example on each rank's rows of the
    batch-laid-out DTensor ``x``, the replicated ``weights`` (trees of
    them) as local tensors whose gradients are partial sums over the
    batch axes; plain tensors go straight through."""
    if not L.is_dtensor(x):
        return fn(x, *weights)
    split = [isinstance(p, Shard) for p in x.placements]

    def local(w):
        if isinstance(w, (nn.Module, dict)):
            return {k: local(v) for k, v in (
                w.named_parameters(recurse=False) if isinstance(w, nn.Module)
                else w.items())}
        return w.to_local(grad_placements=L.grad_parts(w, split))

    return L.like(fn(x.to_local(), *map(local, weights)), x)


def _ln(x, w, eps=1e-6):
    """Population-variance layer norm, weight only (``jnp.var``)."""
    m = torch.mean(x, -1, keepdim=True)
    v = torch.var(x, -1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + eps) * w


def _transformer_block(bp, x, n_heads):
    b, s, dm = x.shape
    hd = dm // n_heads
    h = _ln(x, bp["ln1"])
    q = (h @ bp["wq"]).reshape(b, s, n_heads, hd)
    k = (h @ bp["wk"]).reshape(b, s, n_heads, hd)
    v = (h @ bp["wv"]).reshape(b, s, n_heads, hd)
    logits = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    p = torch.softmax(logits.float(), -1).to(x.dtype)
    att = torch.einsum("bhst,bthd->bshd", p, v).reshape(b, s, dm)
    x = x + att @ bp["wo"]
    h = _ln(x, bp["ln2"])
    return x + F.leaky_relu(h @ bp["ff1"]) @ bp["ff2"]


def sequence_tower(cfg: BSTConfig, params, item_ids, cat_ids):
    """(B, S) ids -> (B, S*2d) transformer-encoded sequence features."""
    e = torch.cat([_lookup(params["item_emb"], item_ids),
                   _lookup(params["cat_emb"], cat_ids)], -1)  # (B,S,2d)

    def tower(e, pos, *blocks):
        x = e + pos[None]
        for bp in blocks:
            x = _transformer_block(bp, x, cfg.n_heads)
        return x.reshape(x.shape[0], -1)

    return _on_rows(tower, e, params["pos_emb"], *params["blocks"])


def forward(cfg: BSTConfig, params, batch: BSTBatch) -> torch.Tensor:
    """CTR logits (B,), float32."""
    b = batch.item_ids.shape[0]
    seq = sequence_tower(cfg, params, batch.item_ids, batch.cat_ids)
    ctx = embedding_bag(params["ctx_emb"], batch.ctx_ids, batch.ctx_segs, b)
    n = len(cfg.mlp_dims) + 1

    def mlp(x, w):
        for i in range(n):
            x = x @ w[f"w{i}"] + w[f"b{i}"]
            if i < n - 1:
                x = F.leaky_relu(x)
        return x[:, 0].float()

    return _on_rows(mlp, torch.cat([seq, ctx], -1), params["mlp"])


def train_loss(cfg: BSTConfig, params, batch: BSTBatch):
    """Mean binary cross entropy of the click labels, in the reference's
    stable form: ``(loss, {"bce": loss})``."""
    logits = forward(cfg, params, batch)
    y = batch.labels.float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"bce": loss}


# ---------------------------------------------------------------------- #
# retrieval: score 1M candidates for one user — batched dot, not a loop
# ---------------------------------------------------------------------- #


def retrieval_scores(cfg: BSTConfig, params, item_ids, cat_ids, ctx_ids,
                     ctx_segs, cand_ids) -> torch.Tensor:
    """(n_cand,) float32 scores: the user tower's output projected by the
    first MLP layer's first ``embed_dim`` columns, tanh, dotted with each
    candidate's item embedding."""
    seq = sequence_tower(cfg, params, item_ids, cat_ids)  # (1, S*2d)
    ctx = embedding_bag(params["ctx_emb"], ctx_ids, ctx_segs, 1)  # (1, d)
    user = torch.cat([seq, ctx], -1)  # (1, D)
    w = params["mlp"]["w0"][:, : cfg.embed_dim]  # (D, d)
    u = torch.tanh(user @ w)  # (1, d)
    if L.is_dtensor(cand_ids):  # ids over every axis, scores gathered
        cand = L.same_layout(
            L.embedding_on_mesh(params["item_emb"], cand_ids), cand_ids)
        return (cand @ u[0]).float().full_tensor()
    cand = params["item_emb"][cand_ids]  # (n_cand, d)
    return (cand @ u[0]).float()


def retrieval_topk(cfg: BSTConfig, params, item_ids, cat_ids, ctx_ids,
                   ctx_segs, cand_ids, k: int = 100):
    """(k largest scores, their candidate ids), largest first; equal
    scores in candidate order, as ``lax.top_k`` orders them (a stable
    descending sort, where ``torch.topk`` promises no order for ties)."""
    scores = retrieval_scores(cfg, params, item_ids, cat_ids, ctx_ids,
                              ctx_segs, cand_ids)
    vals, idx = torch.sort(scores, descending=True, stable=True)
    if L.is_dtensor(cand_ids):
        cand_ids = cand_ids.full_tensor()
    return vals[:k], cand_ids[idx[:k]]
