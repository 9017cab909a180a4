"""Token ids from the seed: the synthetic generator of the port's data
pipeline (a Zipf-like marginal with a Markov overlay), copied so that the
benchmark owns its inputs.  Each (seed, purpose, index) gives one batch,
the same on every run; the successor table is the seed's alone.
"""
from __future__ import annotations

import numpy as np

from .weights import derive

TRAIN, SERVE, WARMUP = 1, 2, 3


class Feed:
    def __init__(self, seed: int, vocab: int):
        self.seed, self.vocab = seed, vocab
        self.succ = np.random.default_rng(derive(seed, 0)).permutation(vocab)

    def ids(self, purpose: int, index: int, rows: int, length: int) -> np.ndarray:
        """(rows, length) int64 ids of batch ``index`` of ``purpose``."""
        rng = np.random.default_rng(derive(self.seed, purpose, index))
        V = self.vocab
        u = rng.random((rows, length))
        base = np.minimum((np.exp(u * 6.0) - 1.0) / (np.e ** 6 - 1.0) * V, V - 1).astype(np.int64)
        follow = rng.random((rows, length)) < 0.5
        out = base.copy()
        out[:, 1:] = np.where(follow[:, 1:], self.succ[base[:, :-1]], base[:, 1:])
        return out
