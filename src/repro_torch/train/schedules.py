"""LR schedules: linear-warmup cosine, and WSD (warmup-stable-decay, the
MiniCPM schedule [arXiv:2404.06395]) — pure functions of the step, in
float32 as the reference computes them; each returns a 0-d float32
tensor on the CPU."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           floor_frac: float = 0.1):
    step = torch.as_tensor(step, dtype=F32)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor_frac * peak_lr + (1 - floor_frac) * peak_lr * 0.5 * (
        1 + torch.cos(math.pi * prog)
    )
    return torch.where(step < warmup, warm, cos)


def wsd(step, *, peak_lr: float, warmup: int, stable: int, decay: int,
        floor_frac: float = 0.01):
    """Warmup-Stable-Decay: the decay phase drops exponentially to
    floor_frac * peak (MiniCPM uses ~10% tail for the decay phase)."""
    step = torch.as_tensor(step, dtype=F32)
    warm = peak_lr * step / max(warmup, 1)
    in_decay = step > (warmup + stable)
    t = torch.clamp((step - warmup - stable) / max(decay, 1), 0, 1)
    decay_lr = peak_lr * torch.exp(torch.log(torch.tensor(floor_frac, dtype=F32)) * t)
    return torch.where(step < warmup, warm,
                       torch.where(in_decay, decay_lr,
                                   torch.tensor(peak_lr, dtype=F32)))


SCHEDULES = {"cosine": cosine, "wsd": wsd}
