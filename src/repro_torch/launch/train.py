"""End-to-end LM training driver of the port: the reference's
``repro/launch/train.py``, flag for flag.

    python -m repro_torch.launch.train --arch minicpm-2b --steps 50

trains the arch's smoke config (``--full``: the published one) on the
CUDA card unless ``--device`` names another, on ``TokenStream`` batches
through ``train.loop.train``.  Fault tolerance is the loop's: atomic async
checkpoints, resume from the directory's newest committed step,
deterministic data skip, straggler logging, a non-finite-loss breaker.

The loop carries the reference's parameter tree — ``embed``,
``final_norm``, ``lm_head`` when untied, and ``layers`` with each leaf
stacked on a leading ``n_layers`` axis — so a checkpoint either package
writes resumes in the other; the loss reads each layer as a view of the
stacked leaves.  ``--seed`` seeds the parameters' generator and the token
stream (the reference draws from ``PRNGKey(0)`` and stream seed 0: the
same distributions, not the same draws).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..checkpoint import wait_for_writes
from ..configs import get_arch
from ..data.tokens import TokenStream
from ..models import transformer as T
from ..train.loop import TrainConfig, resume, train


def build_lm(arch_id: str, full: bool, batch: int, seq: int, scale: int):
    spec = get_arch(arch_id)
    if spec.family != "lm":
        raise SystemExit(f"{arch_id} is not an LM; use its example script")
    cfg = spec.config if full else spec.smoke
    if not full and scale > 1:
        # "~100M" example scale: widen the smoke config
        cfg = dataclasses.replace(
            cfg, d_model=cfg.d_model * scale, d_ff=cfg.d_ff * scale,
            n_layers=min(cfg.n_layers * scale, 12),
            head_dim=cfg.head_dim * max(1, scale // 2),
        )
    return cfg


def stacked_tree(params) -> dict:
    """The reference's tree of the port's LM ``Params`` module: the top
    leaves as they are, each layer leaf stacked over the layers."""
    tree = {k: p.detach() for k, p in params.named_parameters()
            if not k.startswith("layers.")}
    layers = params["layers"]
    tree["layers"] = {k: torch.stack([lp[k].detach() for lp in layers])
                      for k in layers[0]._parameters}
    return tree


def layer_view(tree: dict) -> dict:
    """``tree`` with ``layers`` as a list of per-layer dicts of views
    (``unbind``: the gradients stack back onto the stacked leaves)."""
    per = {k: v.unbind(0) for k, v in tree["layers"].items()}
    return {**tree, "layers": [dict(zip(per, vals))
                               for vals in zip(*per.values())]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the full (paper-exact) config, not smoke")
    ap.add_argument("--scale", type=int, default=1,
                    help="widen the smoke config (4 => ~100M params)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--schedule", default=None,
                    help="cosine|wsd (default: wsd for minicpm else cosine)")
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..core.index import resolve_device

    cfg = build_lm(args.arch, args.full, args.batch, args.seq, args.scale)
    dev = resolve_device(args.device)
    sched = args.schedule or ("wsd" if args.arch == "minicpm-2b" else "cosine")
    print(f"[train] {args.arch}: {cfg.param_count():,} params, "
          f"schedule={sched}, batch={args.batch}x{args.seq}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = stacked_tree(T.init_params(cfg, gen, dev))
    stream = TokenStream(cfg.vocab_size, args.batch * args.accum, args.seq,
                         seed=args.seed)

    def loss_fn(p, batch):
        toks, labels = batch
        return T.train_loss(cfg, layer_view(p), toks, labels)

    def data_at(step):
        toks, labels = stream.batch_at(step)
        if args.accum > 1:
            toks = toks.reshape(args.accum, args.batch, -1)
            labels = labels.reshape(args.accum, args.batch, -1)
        return (torch.from_numpy(toks).to(dev),
                torch.from_numpy(labels).to(dev))

    tcfg = TrainConfig(steps=args.steps, peak_lr=args.lr,
                       warmup=max(args.steps // 10, 5), schedule=sched,
                       accum=args.accum, ckpt_dir=args.ckpt_dir)

    start, opt_state = 0, None
    if args.resume and args.ckpt_dir:
        start, params, opt_state = resume(args.ckpt_dir, params, device=dev)
        if opt_state is not None:
            print(f"[train] resumed from step {start}")

    def on_metrics(rec):
        print(f"  step {rec['step']:5d}  loss {rec['loss']:.4f}  "
              f"lr {rec['lr']:.2e}  gnorm {rec['grad_norm']:.2f}  "
              f"{rec['dt']*1000:.0f}ms" + ("  [STRAGGLER]" if rec["straggler"] else ""))

    params, opt_state, history = train(
        loss_fn, params, data_at, tcfg, on_metrics=on_metrics,
        start_step=start, opt_state=opt_state)
    wait_for_writes()
    print(f"[train] done: loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f} over {len(history)} steps; "
          f"stragglers={sum(h['straggler'] for h in history)}")
    if args.history_out:
        os.makedirs(os.path.dirname(args.history_out) or ".", exist_ok=True)
        with open(args.history_out, "w") as f:
            json.dump(history, f)
    return history


if __name__ == "__main__":
    main()
