"""A frozen copy of the port's synthetic training corpus, drawn in bulk.

The port's ``DecentralizedBatches`` (IID mode) samples an order-1 Markov
token stream one token at a time. This copy draws the same tokens from
the same seed, bit for bit, for many batches at once: each row takes the
same calls on its node's generator in the same order (a start state from
``integers``, then two uniforms a token: the emission and the
transition), and the chains of all rows advance together, one position a
pass. A benchmark run makes every batch of its window in set-up this way.
"""
from __future__ import annotations

import numpy as np

NUM_STATES = 8          # IID mode's number of hidden states


class MarkovCorpus:
    """The corpus of one seed over ``vocab_size`` tokens."""

    def __init__(self, vocab_size: int, seed: int):
        rng = np.random.default_rng(seed)
        trans = rng.dirichlet(np.full(NUM_STATES, 0.3), size=NUM_STATES)
        emit_logits = rng.normal(size=(NUM_STATES, vocab_size)) * 2.0
        self.vocab_size = vocab_size
        # row by row, as the port builds each cdf (the same float sums)
        self.trans_cdf = np.stack([_cdf(row) for row in trans])
        self.emit_cdf = []
        for logits in emit_logits:
            p = np.exp(logits - logits.max())
            p /= p.sum()
            self.emit_cdf.append(_cdf(p))

    def rows(self, starts: np.ndarray, uniforms: np.ndarray) -> np.ndarray:
        """Token rows from each row's start state ``starts`` (R,) and its
        ``(R, 2 L)`` uniforms, emission and transition interleaved."""
        n, length = uniforms.shape[0], uniforms.shape[1] // 2
        states = np.empty((n, length), np.int64)
        s = starts.astype(np.int64)
        for t in range(length):
            states[:, t] = s
            # searchsorted(cdf, u, "right") is the count of cdf values <= u
            s = (self.trans_cdf[s] <= uniforms[:, 2 * t + 1, None]).sum(axis=1)
        emit = uniforms[:, 0::2]
        toks = np.empty((n, length), np.int64)
        for state in range(NUM_STATES):
            mask = states == state
            toks[mask] = self.emit_cdf[state].searchsorted(emit[mask], side="right")
        return toks


def _cdf(p: np.ndarray) -> np.ndarray:
    cdf = p.cumsum()
    cdf /= cdf[-1]
    return cdf


def node_seeds(num_nodes: int, seed: int) -> np.ndarray:
    """Each node's stream seed (IID partition)."""
    return np.random.default_rng(seed).integers(0, 2**31 - 1, size=num_nodes)


def batches(vocab_size: int, num_nodes: int, batch: int, seq: int, count: int,
            seed: int) -> np.ndarray:
    """The first ``count`` batches of the port's stream for ``seed``:
    ``(count, nodes, batch, seq + 1)`` int32 tokens (inputs are
    ``[..., :-1]``, labels ``[..., 1:]``)."""
    corpus = MarkovCorpus(vocab_size, seed)
    length = seq + 1
    out = np.empty((num_nodes, count * batch, length), np.int32)
    for n, s in enumerate(node_seeds(num_nodes, seed)):
        rng = np.random.default_rng(s)
        starts = np.empty(count * batch, np.int64)
        uniforms = np.empty((count * batch, 2 * length))
        for r in range(count * batch):
            starts[r] = rng.integers(NUM_STATES)
            uniforms[r] = rng.random(2 * length)
        out[n] = corpus.rows(starts, uniforms)
    return out.reshape(num_nodes, count, batch, length).transpose(1, 0, 2, 3).copy()
