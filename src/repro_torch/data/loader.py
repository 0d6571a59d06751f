"""Minimal deterministic batch loaders (CPU, numpy-backed).

Counterpart of ``repro.data.loader``, a numpy copy: the same ``rng`` calls
in the same order, so a seed gives the same batches bit for bit.
"""
from __future__ import annotations

import numpy as np


class BatchLoader:
    """Cycles through (x, y) in shuffled batches; epoch-reshuffled."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
        assert len(x) == len(y) and len(x) > 0
        self.x, self.y = x, y
        self.bs = min(batch_size, len(x))
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(x))
        self._pos = 0

    def next(self):
        if self._pos + self.bs > len(self.x):
            self._order = self.rng.permutation(len(self.x))
            self._pos = 0
        idx = self._order[self._pos : self._pos + self.bs]
        self._pos += self.bs
        return self.x[idx], self.y[idx]


def token_batches(rng: np.random.Generator, vocab: int, batch: int, seq: int):
    """Synthetic LM data: Zipf unigram + deterministic bigram successor
    structure, so the loss is reducible and training is observable. Yields
    int32 ``{"tokens", "labels"}`` of shape (batch, seq), labels shifted by
    one."""
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    succ = rng.permutation(vocab)  # bigram successor map
    while True:
        first = rng.choice(vocab, size=(batch, 1), p=probs)
        toks = [first]
        for t in range(seq):
            prev = toks[-1]
            follow = succ[prev]
            rand = rng.choice(vocab, size=prev.shape, p=probs)
            use_follow = rng.random(prev.shape) < 0.7
            toks.append(np.where(use_follow, follow, rand))
        arr = np.concatenate(toks, axis=1).astype(np.int32)
        yield {"tokens": arr[:, :-1], "labels": arr[:, 1:]}
