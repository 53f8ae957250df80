"""Synthetic-but-structured data pipeline with per-node partitioning.

The port of ``repro.data.pipeline``. All sampling is the JAX package's
numpy code, byte for byte, so both packages draw identical tokens from
the same seed; only the final hand-off makes torch tensors on the
requested device instead of jax arrays. Frontend models get their stub
inputs beside the tokens, drawn from the same per-node streams: vision
models a ``prefix_embeddings`` and audio models an ``encoder_frames``
tensor, bf16, bit-equal to the JAX package's. The dry-run
``input_specs`` is not ported yet (ROADMAP queue 1, item 17).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Synthetic corpus
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class SyntheticCorpus:
    """Order-1 Markov token stream: low-entropy, learnable, seeded."""

    vocab_size: int
    num_states: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse-ish transition structure between hidden states
        self.trans = rng.dirichlet(np.full(self.num_states, 0.3),
                                   size=self.num_states)
        # each state emits from a small slice of the vocab
        self.emit_logits = rng.normal(
            size=(self.num_states, self.vocab_size)
        ) * 2.0

    def sample(
        self,
        rng: np.random.Generator,
        length: int,
        state_prior: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Sample a token stream; ``state_prior`` (num_states,) tilts the
        chain toward a node's own hidden states (start state drawn from
        it, every transition row reweighted by it) so per-node priors
        produce genuinely different stationary token distributions — the
        non-IID partition. ``None`` keeps the shared (IID) chain."""
        states = np.zeros(length, np.int64)
        if state_prior is None:
            s = rng.integers(self.num_states)
        else:
            s = rng.choice(self.num_states, p=state_prior)
        toks = np.zeros(length, np.int64)
        for t in range(length):
            states[t] = s
            p = np.exp(self.emit_logits[s] - self.emit_logits[s].max())
            p /= p.sum()
            toks[t] = rng.choice(self.vocab_size, p=p)
            trans = self.trans[s]
            if state_prior is not None:
                trans = trans * (state_prior + 1e-6)
                trans = trans / trans.sum()
            s = rng.choice(self.num_states, p=trans)
        return toks


# ---------------------------------------------------------------------------
# Decentralized partitioning
# ---------------------------------------------------------------------------
def partition_seeds(
    num_nodes: int,
    *,
    iid: bool = True,
    seed: int = 0,
    num_states: Optional[int] = None,
    concentration: float = 0.3,
):
    """Per-node stream seeds + hidden-state priors.

    Returns ``(seeds, priors)``: ``seeds`` (num_nodes,) int — one
    independent sample stream per node; ``priors`` — each node's
    distribution over the corpus's hidden Markov states. IID mode keeps
    ``priors=None`` (every node samples the shared chain — same D_i);
    non-IID mode draws one ``Dirichlet(concentration)`` vector per node
    (num_nodes, num_states), the skewed local distributions D_i the
    paper partitions with. Low concentration = strong skew.
    ``num_states`` defaults to the corpus size ``DecentralizedBatches``
    builds for the mode (8 IID / 4 non-IID).
    """
    if num_states is None:
        num_states = 8 if iid else 4
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31 - 1, size=num_nodes)
    if iid:
        return seeds, None
    priors = rng.dirichlet(
        np.full(num_states, concentration), size=num_nodes
    )
    return seeds, priors


class DecentralizedBatches:
    """Iterator of {tokens, labels} with leading (nodes, batch) dims,
    as int32 tensors on ``device``, plus a frontend model's bf16 stub
    (``prefix_embeddings`` or ``encoder_frames``, (nodes, batch,
    encoder_seq, frontend_dim))."""

    def __init__(
        self,
        cfg: ModelConfig,
        num_nodes: int,
        batch_per_node: int,
        seq_len: int,
        *,
        iid: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_nodes = num_nodes
        self.batch_per_node = batch_per_node
        self.seq_len = seq_len
        self.corpus = SyntheticCorpus(
            cfg.vocab_size, num_states=8 if iid else 4, seed=seed
        )
        seeds, priors = partition_seeds(
            num_nodes, iid=iid, seed=seed,
            num_states=self.corpus.num_states,
        )
        self.node_rngs = [np.random.default_rng(s) for s in seeds]
        self.node_priors = priors          # None for IID

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return self

    def _frontend_stub(self) -> np.ndarray:
        """Per-(node, batch) stand-in embeddings, drawn fresh from each
        node's stream rng every batch, after all nodes' tokens."""
        N, B = self.num_nodes, self.batch_per_node
        fd = self.cfg.frontend_dim or self.cfg.d_model
        return np.stack([
            self.node_rngs[n].normal(size=(B, self.cfg.encoder_seq, fd))
            for n in range(N)
        ])

    def __next__(self) -> Dict[str, torch.Tensor]:
        N, B, S = self.num_nodes, self.batch_per_node, self.seq_len
        toks = np.zeros((N, B, S + 1), np.int32)
        for n in range(N):
            prior = None if self.node_priors is None else self.node_priors[n]
            for b in range(B):
                toks[n, b] = self.corpus.sample(
                    self.node_rngs[n], S + 1, state_prior=prior
                )
        batch = {
            "tokens": torch.as_tensor(toks[..., :-1], device=self.device),
            "labels": torch.as_tensor(toks[..., 1:], device=self.device),
        }
        key = {"vision": "prefix_embeddings", "audio": "encoder_frames"}.get(
            self.cfg.frontend)
        if key is not None:
            batch[key] = to_bfloat16(self._frontend_stub()).to(self.device)
        return batch


def to_bfloat16(a: np.ndarray) -> torch.Tensor:
    """float64 numbers -> bf16, rounded as the JAX package rounds them
    (``jnp.asarray(a, jnp.bfloat16)``)."""
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)
