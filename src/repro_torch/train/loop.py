"""Fault-tolerant training loop — the reference's ``repro/train/loop.py``
over trees of tensors.

  * deterministic, stateless data (``data_at(step)``): any host can
    resume at any step with no pipeline state;
  * checkpoint/restart: atomic async checkpoints every ``ckpt_every``
    steps through ``repro_torch.checkpoint`` (the reference's layout, so
    either package restores the other's); :func:`resume` picks a run up
    at the directory's ``latest_step``;
  * straggler mitigation: a per-step wall-time EWMA with a deadline
    multiplier; steps past it are recorded and surfaced;
  * gradient accumulation: ``accum`` microbatches an optimizer step over
    the batch's leading axis, float32 gradients summed in a loop;
  * non-finite-loss circuit breaker: a NaN/inf step is a no-op on the
    parameters, counted, and the run aborts after ``max_bad_steps`` in a
    row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from .optim import (AdamWState, adamw_init, adamw_update, tree_leaves,
                    tree_map, tree_unflatten)
from .schedules import SCHEDULES


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    peak_lr: float = 3e-4
    warmup: int = 20
    schedule: str = "cosine"  # or "wsd" (minicpm)
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    accum: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0
    max_bad_steps: int = 5


@dataclasses.dataclass
class StragglerStats:
    ewma: float = 0.0
    n_stragglers: int = 0
    worst: float = 0.0

    def observe(self, dt: float, factor: float) -> bool:
        if self.ewma == 0.0:
            self.ewma = dt
        is_straggler = dt > factor * self.ewma and self.ewma > 0
        self.ewma = 0.9 * self.ewma + 0.1 * dt
        self.worst = max(self.worst, dt)
        if is_straggler:
            self.n_stragglers += 1
        return is_straggler


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, aux, grads)`` of ``loss_fn(params, batch) -> (loss, aux)``
    with grads a tree like ``params`` (zeros for an unused leaf)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), aux, tree_unflatten(params, grads)


def make_train_step(loss_fn: Callable, tcfg: TrainConfig):
    """``loss_fn(params, batch) -> (loss, aux)``.  Returns
    ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)`` with gradient accumulation."""
    sched = SCHEDULES[tcfg.schedule]

    def lr_at(step):
        if tcfg.schedule == "wsd":
            stable = int(tcfg.steps * 0.8) - tcfg.warmup
            decay = tcfg.steps - tcfg.warmup - stable
            return sched(step, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                         stable=stable, decay=max(decay, 1))
        return sched(step, peak_lr=tcfg.peak_lr, warmup=tcfg.warmup,
                     total=tcfg.steps)

    def step_fn(params, opt_state: AdamWState, batch, step_idx):
        if tcfg.accum == 1:
            loss, aux, grads = value_and_grad(loss_fn, params, batch)
        else:
            # microbatches over the leading axis: batch leaves are
            # (accum, micro, ...); float32 grads summed one at a time
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, auxes = [], []
            for i in range(tcfg.accum):
                mb = tree_map(lambda x: x[i], batch)
                loss_i, aux_i, g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda acc, gi: acc + gi, grads, g)
                losses.append(loss_i)
                auxes.append(aux_i)
            grads = tree_map(lambda g: g / tcfg.accum, grads)
            loss = torch.mean(torch.stack(losses))
            aux = tree_map(lambda *xs: torch.mean(torch.stack(xs)), *auxes)
        lr = lr_at(step_idx)
        finite = torch.isfinite(loss)
        safe_grads = tree_map(
            lambda g: torch.where(finite, g, torch.zeros_like(g)), grads)
        new_params, new_opt, om = adamw_update(
            safe_grads, opt_state, params, lr,
            weight_decay=tcfg.weight_decay, clip_norm=tcfg.clip_norm)
        # a non-finite step is a no-op on params
        new_params = tree_map(lambda n, o: torch.where(finite, n, o.detach()),
                              new_params, params)
        metrics = {"loss": loss, "lr": lr, "finite": finite, **om}
        return new_params, new_opt, metrics

    return step_fn


def resume(ckpt_dir: str, params, device=None):
    """``(start_step, params, opt_state)`` from the newest committed
    checkpoint under ``ckpt_dir`` (the CUDA card unless ``device`` names
    another); ``(0, params, None)`` when there is none."""
    from ..checkpoint import latest_step, restore_sharded

    last = latest_step(ckpt_dir)
    if last is None:
        return 0, params, None
    like = {"params": params, "opt": adamw_init(params)}
    restored = restore_sharded(ckpt_dir, last, like, device=device)
    return last, restored["params"], restored["opt"]


def train(loss_fn: Callable, params, data_at: Callable, tcfg: TrainConfig,
          step_fn=None, on_metrics: Optional[Callable] = None,
          start_step: int = 0, opt_state: Optional[AdamWState] = None):
    """Single-process driver.  Returns ``(params, opt_state, history)``."""
    from ..checkpoint import save_checkpoint

    step_fn = step_fn or make_train_step(loss_fn, tcfg)
    opt_state = opt_state if opt_state is not None else adamw_init(params)
    history = []
    stats = StragglerStats()
    bad = 0
    for step in range(start_step, tcfg.steps):
        t0 = time.perf_counter()
        batch = data_at(step)
        params, opt_state, m = step_fn(params, opt_state, batch,
                                       torch.tensor(step, dtype=torch.int32))
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
        straggle = stats.observe(dt, tcfg.straggler_factor)
        if not np.isfinite(loss):
            bad += 1
            if bad > tcfg.max_bad_steps:
                raise FloatingPointError(
                    f"{bad} consecutive non-finite losses at step {step}")
        else:
            bad = 0
        rec = {"step": step, "loss": loss, "lr": float(m["lr"]),
               "grad_norm": float(m["grad_norm"]), "dt": dt,
               "straggler": straggle}
        history.append(rec)
        if on_metrics and step % tcfg.log_every == 0:
            on_metrics(rec)
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            save_checkpoint(tcfg.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state},
                            async_write=True)
    return params, opt_state, history
