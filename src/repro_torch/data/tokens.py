"""Deterministic synthetic token stream for LM training: the reference's
``repro/data/tokens.py``, numpy for numpy, so a batch is bit-identical to
the reference's at every (seed, step).

Zipf-distributed tokens with a simple bigram structure so loss curves are
non-trivial (the model can learn something); fully deterministic in
(seed, step) so a resumed run can skip to any step without state — the
fault-tolerance contract of the train loop."""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        ranks = np.arange(1, vocab_size + 1)
        w = 1.0 / ranks ** zipf_a
        self.p = w / w.sum()

    def batch_at(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for a given global step — stateless."""
        rng = np.random.default_rng((self.seed, step))
        toks = rng.choice(self.vocab, size=(self.batch, self.seq + 1),
                          p=self.p).astype(np.int32)
        # bigram structure: every even position strongly predicts +1
        toks[:, 1::2] = (toks[:, 0:-1:2] + 1) % self.vocab
        return toks[:, :-1], toks[:, 1:]

    def shard_at(self, step: int, shard: int, n_shards: int):
        """One data-parallel shard's slice of the global batch: each host
        materializes only its rows."""
        toks, labels = self.batch_at(step)
        b = self.batch // n_shards
        sl = slice(shard * b, (shard + 1) * b)
        return toks[sl], labels[sl]
