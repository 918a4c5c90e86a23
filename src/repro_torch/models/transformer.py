"""Decoder-only LM of the port, for all five architectures of the reference:

  grok-1-314b        MoE 8e top-2, GQA kv=8
  granite-moe-3b     MoE 40e top-8, tiny per-expert FFN
  gemma2-2b          dense, alternating local/global attention, softcaps,
                     GeGLU, sandwich norms, gemma-style RMSNorm
  minicpm-2b         dense llama-like with muP-style embed/residual scaling
  mistral-nemo-12b   dense, head_dim 128 != d_model/n_heads, 128k rope

Counterpart of the reference's ``repro/models/transformer.py``, function
for function and with the same parameter names.  The reference stacks
each layer leaf on a leading ``n_layers`` axis and scans over it; here
``params["layers"]`` is an ``nn.ModuleList`` with one ``Params`` entry a
layer and the scan is a Python loop.  ``convert.lm_params_from_numpy`` /
``lm_params_to_numpy`` carry a tree across.

The KV cache keeps the reference's layout, ``{"k", "v"}`` of shape
(n_layers, B, max_len, KV, head_dim); ``prefill`` and ``decode_step``
write into the cache they are given and return it (the reference's cells
donate it).  They run under ``torch.no_grad``; ``forward`` and
``train_loss`` leave autograd to the caller.

Entry points:
  init_params(cfg, generator, device)       parameter module
  train_loss(cfg, params, tokens, labels)   next-token CE loss (f32)
  prefill(cfg, params, tokens, cache)       logits + KV cache
  decode_step(cfg, params, cache, tok, pos) one-token serve step
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from . import layers as L
from .gnn import Params


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # attention flavor
    attn_pattern: tuple = ("global",)  # cycled over layers
    window: int = 4096
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    # norm / activation / scaling
    activation: str = "silu"
    gemma_norms: bool = False  # (1+w) RMSNorm + sandwich (post) norms
    embed_scale: Optional[float] = None  # e.g. sqrt(d_model) (gemma), 12 (minicpm)
    residual_scale: Optional[float] = None  # minicpm depth scaling
    logit_scale: Optional[float] = None  # minicpm: d_model/dim_model_base
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    max_seq_len: int = 131_072
    # vocab padded for TP divisibility (logical vocab_size preserved)
    vocab_pad_to: int = 256
    # the reference's memory and sharding knobs, kept so that a config is
    # the reference's field for field: ``q_chunk`` selects the chunked
    # attention for sequences >= 2 * q_chunk (0 disables); ``remat`` and
    # the axis hints place work on a TPU mesh and change no value, so the
    # port's eager one-card path does not read them
    remat: bool = False
    q_chunk: int = 0
    attn_batch_axes: tuple = ()
    attn_seq_axes: tuple = ()
    moe_c_axes: tuple = ()

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kind(self, i: int) -> str:
        return self.attn_pattern[i % len(self.attn_pattern)]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Exact parameter count (excluding vocab padding)."""
        d, h, kv, hd, f, v = (self.d_model, self.n_heads, self.n_kv_heads,
                              self.head_dim, self.d_ff, self.vocab_size)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.is_moe:
            ffn = self.n_experts * 3 * d * f + d * self.n_experts
        else:
            ffn = 3 * d * f
        norms = 2 * d + (2 * d if self.gemma_norms else 0)
        per_layer = attn + ffn + norms
        head = 0 if self.tie_embeddings else d * v
        return self.n_layers * per_layer + v * d + d + head


# ---------------------------------------------------------------------- #
# parameters
# ---------------------------------------------------------------------- #


def init_params(cfg: LMConfig, generator: torch.Generator,
                device=None) -> Params:
    """Fresh parameters of ``cfg`` on the CUDA card unless ``device``
    names another, drawn from ``generator`` as the reference draws from
    its key: normal / sqrt(fan_in) weights (the output projections also
    times 1/sqrt(2 n_layers)), norms at 1 (0 for gemma-style norms).  The
    same distributions as the reference, not the same draws; each layer
    is drawn on its own, so a float32 temporary never exceeds one layer's
    largest weight.  ``device="meta"`` builds the tree without drawing or
    allocating."""
    from ..core.index import resolve_device

    dev = resolve_device(device)
    dt = cfg.dtype
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                       cfg.d_ff)
    depth_scale = 1.0 / math.sqrt(2 * cfg.n_layers)
    norm_one = 0.0 if cfg.gemma_norms else 1.0

    def w(shape, scale=1.0):
        return L.normal_init(generator, shape, dt, scale, dev)

    def full(value):
        return torch.full((d,), value, dtype=dt, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {"attn_norm": full(norm_one), "wq": w((d, h * hd)),
              "wk": w((d, kv * hd)), "wv": w((d, kv * hd)),
              "wo": w((h * hd, d), depth_scale), "mlp_norm": full(norm_one)}
        if cfg.gemma_norms:
            lp["post_attn_norm"] = full(0.0)
            lp["post_mlp_norm"] = full(0.0)
        if cfg.is_moe:
            e = cfg.n_experts
            lp["router"] = w((d, e))
            lp["w_gate"] = w((e, d, f))
            lp["w_up"] = w((e, d, f))
            lp["w_down"] = w((e, f, d), depth_scale)
        else:
            lp["w_gate"] = w((d, f))
            lp["w_up"] = w((d, f))
            lp["w_down"] = w((f, d), depth_scale)
        layers.append(Params(**lp))
    top = {"embed": w((cfg.padded_vocab, d)), "final_norm": full(norm_one)}
    if not cfg.tie_embeddings:
        top["lm_head"] = w((d, cfg.padded_vocab))
    return Params(**top, layers=nn.ModuleList(layers))


# ---------------------------------------------------------------------- #
# forward
# ---------------------------------------------------------------------- #


def _norm(x, w, cfg):
    return L.rms_norm(x, w, cfg.norm_eps, gemma_style=cfg.gemma_norms)


def _layer_masks(cfg: LMConfig, s_q: int, s_kv: int, q_offset: int = 0,
                 device=None):
    """One mask per attention kind used by the pattern."""
    masks = {}
    for kd in sorted(set(cfg.attn_pattern)):
        win = cfg.window if kd == "local" else None
        masks[kd] = L.causal_mask(s_q, s_kv, window=win, q_offset=q_offset,
                                  device=device)
    return masks


def _kind_code(cfg: LMConfig, i: int) -> int:
    return 0 if cfg.layer_kind(i) == "global" else 1


def _as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: JAX casts a Python scalar to the
    array's dtype before it multiplies, PyTorch multiplies bfloat16 by
    the float32 scalar."""
    return float(torch.tensor(value, dtype=dtype))


def _write_cache(c: torch.Tensor, new: torch.Tensor, pos) -> None:
    """``lax.dynamic_update_slice(c, new, (0, pos, 0, 0))`` in place: the
    start is clamped so that the update fits, as XLA clamps it."""
    s, t = new.shape[1], c.shape[1]
    start = min(max(int(pos), 0), t - s)
    c[:, start:start + s] = new.to(c.dtype)


def _block(cfg: LMConfig, x, lp, kind_code: int, masks, cos, sin, positions,
           cache_kv=None, cache_pos=None):
    """One transformer block.  ``kind_code``: 0 global / 1 local.  A given
    ``cache_kv`` (k, v) of shape (B, max_len, KV, hd) is written at
    ``cache_pos`` in place.  Returns (x, cache_kv, aux)."""
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    a_in = _norm(x, lp["attn_norm"], cfg)
    q = (a_in @ lp["wq"]).reshape(b, s, h, hd)
    kk = (a_in @ lp["wk"]).reshape(b, s, kv, hd)
    vv = (a_in @ lp["wv"]).reshape(b, s, kv, hd)
    q = L.apply_rope(q, cos, sin, positions)
    kk = L.apply_rope(kk, cos, sin, positions)

    if cache_kv is not None:
        ck, cv = cache_kv
        _write_cache(ck, kk, cache_pos)
        _write_cache(cv, vv, cache_pos)
        k_att, v_att = ck, cv
    else:
        k_att, v_att = kk, vv

    t_kv = k_att.shape[1]
    if cfg.q_chunk and s >= 2 * cfg.q_chunk:
        # long-sequence path: never materialize the (S, T) mask or logits
        qpos = (positions.reshape(-1)[:s] if positions.shape[-1] == s
                else torch.arange(s, device=x.device))
        kpos = torch.arange(t_kv, device=x.device)
        window = t_kv + 1 if kind_code == 0 else cfg.window
        att = L.chunked_gqa_attention(q, k_att, v_att, qpos, kpos, window,
                                      scale=hd ** -0.5,
                                      softcap=cfg.attn_softcap,
                                      q_chunk=cfg.q_chunk)
    else:
        mask = (masks["global"] if kind_code == 0
                else masks.get("local", masks["global"]))
        att = L.gqa_attention(q, k_att, v_att, mask, scale=hd ** -0.5,
                              softcap=cfg.attn_softcap)
    att = att.reshape(b, s, h * hd) @ lp["wo"]
    if cfg.gemma_norms:
        att = _norm(att, lp["post_attn_norm"], cfg)
    if cfg.residual_scale is not None:
        att = att * _as(cfg.residual_scale, att.dtype)
    x = x + att

    m_in = _norm(x, lp["mlp_norm"], cfg)
    if cfg.is_moe:
        dims = L.MoEDims(cfg.n_experts, cfg.top_k,
                         L.moe_capacity(s, cfg.top_k, cfg.n_experts,
                                        cfg.capacity_factor))
        mlp, aux = L.moe_ffn(m_in, lp["router"], lp["w_gate"], lp["w_up"],
                             lp["w_down"], dims, cfg.activation)
    else:
        mlp = L.gated_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"],
                          cfg.activation)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = {"moe_aux_loss": zero, "moe_dropped_frac": zero}
    if cfg.gemma_norms:
        mlp = _norm(mlp, lp["post_mlp_norm"], cfg)
    if cfg.residual_scale is not None:
        mlp = mlp * _as(cfg.residual_scale, mlp.dtype)
    return x + mlp, cache_kv, aux


def _embed(cfg: LMConfig, params, tokens):
    x = params["embed"][tokens]
    if cfg.embed_scale is not None:
        x = x * _as(cfg.embed_scale, x.dtype)
    return x


def _unembed(cfg: LMConfig, params, x):
    x = _norm(x, params["final_norm"], cfg)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ w).float()
    if cfg.logit_scale is not None:
        logits = logits * cfg.logit_scale
    return L._softcap(logits, cfg.final_softcap)


def _rope(cfg: LMConfig, device):
    return L.rope_table(cfg.head_dim, cfg.max_seq_len, cfg.rope_theta, device)


def forward(cfg: LMConfig, params, tokens: torch.Tensor,
            positions: torch.Tensor | None = None):
    """Full-sequence forward (training / prefill compute).  Returns
    (float32 logits (B, S, padded_vocab), mean MoE aux loss)."""
    b, s = tokens.shape
    dev = tokens.device
    if positions is None:
        positions = torch.arange(s, device=dev)[None]
    cos, sin = _rope(cfg, dev)
    chunked = cfg.q_chunk and s >= 2 * cfg.q_chunk
    masks = ({"global": torch.ones((1, 1), dtype=torch.bool, device=dev)}
             if chunked else _layer_masks(cfg, s, s, device=dev))
    x = _embed(cfg, params, tokens)
    aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for i, lp in enumerate(params["layers"]):
        x, _, aux = _block(cfg, x, lp, _kind_code(cfg, i), masks, cos, sin,
                           positions)
        aux_sum = aux_sum + aux["moe_aux_loss"]
    return _unembed(cfg, params, x), aux_sum / cfg.n_layers


def train_loss(cfg: LMConfig, params, tokens: torch.Tensor,
               labels: torch.Tensor, aux_weight: float = 0.01):
    """Next-token cross entropy over the labels >= 0, plus ``aux_weight``
    times the MoE aux loss: ``(loss, {"ce_loss", "aux"})``.  The label's
    logit is read by a gather where the reference sums an iota/where
    product: one non-zero term, the same value."""
    logits, aux = forward(cfg, params, tokens)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    v = logits.shape[-1]
    inside = (labels >= 0) & (labels < v)
    picked = torch.gather(logits, -1, labels.clamp(0, v - 1).long()[..., None])
    correct = torch.where(inside, picked[..., 0], 0.0)
    ll = correct - lse
    mask = labels >= 0
    loss = -torch.sum(torch.where(mask, ll, 0.0)) / torch.clamp(
        torch.sum(mask), min=1)
    return loss + aux_weight * aux, {"ce_loss": loss, "aux": aux}


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #


def make_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache (n_layers, batch, max_len, KV, head_dim) in ``dtype``
    (the config's by default) on ``device`` (the CPU by default)."""
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def prefill(cfg: LMConfig, params, tokens: torch.Tensor, cache: dict):
    """Run the prompt, filling the cache from position 0.  Returns
    (last-token logits (B, padded_vocab), cache)."""
    b, s = tokens.shape
    dev = tokens.device
    max_len = cache["k"].shape[2]
    positions = torch.arange(s, device=dev)[None]
    cos, sin = _rope(cfg, dev)
    chunked = cfg.q_chunk and s >= 2 * cfg.q_chunk
    masks = ({"global": torch.ones((1, 1), dtype=torch.bool, device=dev)}
             if chunked else _layer_masks(cfg, s, max_len, device=dev))
    x = _embed(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(cfg, x, lp, _kind_code(cfg, i), masks, cos, sin,
                         positions, cache_kv=(cache["k"][i], cache["v"][i]),
                         cache_pos=0)
    logits = _unembed(cfg, params, x[:, -1:, :])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(cfg: LMConfig, params, cache: dict, tokens: torch.Tensor,
                pos):
    """One-token decode: tokens (B, 1), ``pos`` the current position (an
    int or a 0-d tensor).  Returns (logits (B, padded_vocab), cache)."""
    b = tokens.shape[0]
    dev = tokens.device
    max_len = cache["k"].shape[2]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=dev)
    cos, sin = _rope(cfg, dev)
    # masks over the cache: global = all positions <= pos; local = window
    t = torch.arange(max_len, device=dev)[None, :]
    gmask = t <= pos
    masks = {"global": gmask, "local": gmask & (t > pos - cfg.window)}
    x = _embed(cfg, params, tokens)
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _block(cfg, x, lp, _kind_code(cfg, i), masks, cos, sin,
                         positions, cache_kv=(cache["k"][i], cache["v"][i]),
                         cache_pos=pos)
    logits = _unembed(cfg, params, x)
    return logits[:, 0], cache
