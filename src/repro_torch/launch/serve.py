"""Serving driver of the port: batched-request LM inference with slot-based
continuous batching — the reference's ``repro/launch/serve.py``.

A fixed pool of batch slots; each incoming request claims a slot, its
prompt is fed token by token through the shared one-token step, then it
joins the decode loop; a finished slot is reused at once.  Every slot
decodes at its own position (the decode mask is per example).

The step keeps a fault of the reference on purpose: it leaves out
``cfg.residual_scale``, which ``models.transformer._block`` applies, so
for minicpm-2b (the one config that sets it) the served logits differ
from ``transformer.decode_step`` (ROADMAP Queue 3).  The port's contract
is the reference's function.

Run it as ``python -m repro_torch.launch.serve [--device cpu]``: the smoke
config of ``--arch``, on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from ..configs import get_arch
from ..models import layers as L
from ..models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


@torch.no_grad()
def _decode_step_multi(cfg, params, cache, tokens, positions):
    """decode_step with *per-slot* positions (B,) — the continuous
    batching variant: each slot attends to its own prefix length.  The
    cache is written in place, each slot's row at its own position (the
    reference's one-hot ``where`` over the whole cache, as an indexed
    write: a position outside the cache writes nothing)."""
    b = tokens.shape[0]
    dev = tokens.device
    max_len = cache["k"].shape[2]
    cos, sin = T._rope(cfg, dev)
    t = torch.arange(max_len, device=dev)[None, :]
    gmask = t <= positions[:, None]
    lmask = gmask & (t > (positions[:, None] - cfg.window))
    x = T._embed(cfg, params, tokens)
    pos3 = positions[:, None]
    rows = torch.arange(b, device=dev)
    inside = ((positions >= 0) & (positions < max_len))[:, None, None]
    at = positions.clamp(0, max_len - 1)
    for i, lp in enumerate(params["layers"]):
        ck, cv = cache["k"][i], cache["v"][i]
        a_in = T._norm(x, lp["attn_norm"], cfg)
        q = (a_in @ lp["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        kk = (a_in @ lp["wk"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        vv = (a_in @ lp["wv"]).reshape(b, 1, cfg.n_kv_heads, cfg.head_dim)
        q = L.apply_rope(q, cos, sin, pos3)
        kk = L.apply_rope(kk, cos, sin, pos3)
        ck[rows, at] = torch.where(inside, kk[:, 0].to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(inside, vv[:, 0].to(cv.dtype), cv[rows, at])
        mask = gmask if T._kind_code(cfg, i) == 0 else lmask
        att = L.gqa_attention(q, ck, cv, mask[:, None, :],
                              scale=cfg.head_dim ** -0.5,
                              softcap=cfg.attn_softcap)
        att = att.reshape(b, 1, -1) @ lp["wo"]
        if cfg.gemma_norms:
            att = T._norm(att, lp["post_attn_norm"], cfg)
        x = x + att  # no residual_scale: the reference's step leaves it out
        m_in = T._norm(x, lp["mlp_norm"], cfg)
        if cfg.is_moe:
            dims = L.MoEDims(cfg.n_experts, cfg.top_k,
                             L.moe_capacity(1, cfg.top_k, cfg.n_experts,
                                            cfg.capacity_factor))
            mlp, _ = L.moe_ffn(m_in, lp["router"], lp["w_gate"], lp["w_up"],
                               lp["w_down"], dims, cfg.activation)
        else:
            mlp = L.gated_mlp(m_in, lp["w_gate"], lp["w_up"], lp["w_down"],
                              cfg.activation)
        if cfg.gemma_norms:
            mlp = T._norm(mlp, lp["post_mlp_norm"], cfg)
        x = x + mlp
    logits = T._unembed(cfg, params, x)
    return logits[:, 0], cache


class Server:
    """Continuous batching over ``n_slots`` cache rows of ``max_len``
    positions, on the CUDA card unless ``device`` names another; the
    parameters must lie there.  ``_step`` is the one compiled step of the
    reference, here the eager :func:`_decode_step_multi`."""

    def __init__(self, cfg, params, n_slots: int, max_len: int, device=None):
        from ..core.index import resolve_device

        self.device = resolve_device(device)
        where = next(params.parameters()).device
        if where != self.device:
            raise ValueError(f"the server runs on {self.device}; its "
                             f"parameters lie on {where}")
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = T.make_cache(cfg, n_slots, max_len, device=self.device)
        self.positions = np.full(n_slots, -1, np.int64)  # -1 = free
        self.slot_req: list = [None] * n_slots
        self._step = lambda p, c, t, pos: _decode_step_multi(cfg, p, c, t, pos)
        self.steps = 0

    def _free_slots(self):
        return [i for i in range(self.n_slots) if self.positions[i] < 0]

    def admit(self, req: Request) -> bool:
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        # prefill: feed prompt tokens one by one through the decode step
        self.slot_req[slot] = req
        self.positions[slot] = 0
        for tok in req.prompt:
            self._one_step_for(slot, tok)
        return True

    def _run(self, toks: np.ndarray):
        pos = np.maximum(self.positions, 0)
        logits, self.cache = self._step(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        self.steps += 1
        return logits

    def _one_step_for(self, slot, tok):
        """One step feeding ``tok`` to ``slot``; its logits row (a tensor
        on the device: the reference pulls it to the host, and discards
        it)."""
        toks = np.zeros((self.n_slots, 1), np.int64)
        toks[slot, 0] = tok
        logits = self._run(toks)
        self.positions[slot] += 1
        return logits[slot]

    def step_all(self):
        """One decode step for every active slot (continuous batching)."""
        active = [i for i in range(self.n_slots)
                  if self.positions[i] > 0 and self.slot_req[i] is not None]
        if not active:
            return
        toks = np.zeros((self.n_slots, 1), np.int64)
        for i in active:
            req = self.slot_req[i]
            toks[i, 0] = req.out[-1] if req.out else req.prompt[-1]
        # greedy: the first index of the largest logit, as np.argmax
        nxt = torch.argmax(self._run(toks), dim=-1).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            req.out.append(int(nxt[i]))
            self.positions[i] += 1
            if len(req.out) >= req.max_new or self.positions[i] >= self.max_len - 1:
                req.done = True
                self.slot_req[i] = None
                self.positions[i] = -1  # slot free for the next request


def main(argv=None) -> Server:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..core.index import resolve_device

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).smoke
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    server = Server(cfg, params, args.slots, args.max_len, device=dev)

    rng = np.random.default_rng(0)
    pending = [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).tolist(),
                max_new=args.max_new)
        for i in range(args.requests)
    ]
    while pending or any(server.slot_req):
        while pending and server.admit(pending[0]):
            req = pending.pop(0)
            print(f"[serve] admitted request {req.rid}")
        server.step_all()
    print(f"[serve] all {args.requests} requests done in {server.steps} steps "
          f"with {args.slots} slots (continuous batching)")
    return server


if __name__ == "__main__":
    main()
