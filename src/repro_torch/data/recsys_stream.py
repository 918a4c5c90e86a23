"""Deterministic behavior-sequence stream for BST training/serving: the
reference's ``repro/data/recsys_stream.py``, numpy for numpy, so a batch is
bit-identical to the reference's at every (seed, step)."""

from __future__ import annotations

import numpy as np

from ..models.recsys import BSTBatch, BSTConfig


def batch_at(cfg: BSTConfig, batch: int, step: int, seed: int = 0) -> BSTBatch:
    rng = np.random.default_rng((seed, step))
    f = cfg.n_context_fields
    # zipf-ish item popularity
    w = 1.0 / np.arange(1, cfg.n_items + 1) ** 1.1
    p = w / w.sum()
    items = rng.choice(cfg.n_items, size=(batch, cfg.seq_len), p=p)
    cats = (items % cfg.n_cats).astype(np.int64)
    ctx = rng.integers(0, cfg.n_context, batch * f)
    segs = np.repeat(np.arange(batch), f)
    # clicks correlate with matching category between target and history
    match = (cats[:, -1:] == cats[:, :-1]).mean(1)
    labels = (rng.random(batch) < (0.2 + 0.6 * match)).astype(np.int32)
    return BSTBatch(
        item_ids=items.astype(np.int32), cat_ids=cats.astype(np.int32),
        ctx_ids=ctx.astype(np.int32), ctx_segs=segs.astype(np.int32),
        labels=labels,
    )
