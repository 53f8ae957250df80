"""A-priori random topology schedules (Step 3 of MATCHA).

The paper stresses that the whole sequence {G^(k)} can be generated
*before* training ("no additional runtime overhead"). ``TopologySchedule``
pre-draws the i.i.d. Bernoulli activations from a seed and exposes them
as a dense (K, M) uint8 array plus helpers for the distributed runtime
(per-iteration activated matching indices, laplacians, W matrices).

Also provides the two baselines used throughout the paper:
  * vanilla DecenSGD  — every matching active at every iteration;
  * P-DecenSGD        — all matchings active together every 1/CB-th
    iteration (communication frequency == budget).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.graphs import Graph


@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """Pre-generated activation sequence B in {0,1}^(K, M)."""

    activations: np.ndarray           # (K, M) uint8
    matchings: Tuple[Graph, ...]
    kind: str                          # "matcha" | "vanilla" | "periodic"

    @property
    def num_iterations(self) -> int:
        return self.activations.shape[0]

    @property
    def num_matchings(self) -> int:
        return self.activations.shape[1]

    def active_indices(self, k: int) -> Tuple[int, ...]:
        return tuple(int(j) for j in np.flatnonzero(self.activations[k]))

    def laplacian(self, k: int) -> np.ndarray:
        m = self.matchings[0].m
        L = np.zeros((m, m))
        for j in self.active_indices(k):
            L += self.matchings[j].laplacian()
        return L

    def comm_units(self, k: int) -> int:
        """Communication delay of iteration k in the paper's unit model
        (one unit per activated matching; matchings run in parallel
        internally)."""
        return int(self.activations[k].sum())

    def expected_comm_units(self) -> float:
        return float(self.activations.sum(axis=1).mean())


def matcha_schedule(
    matchings: Sequence[Graph],
    probabilities: np.ndarray,
    num_iterations: int,
    seed: int = 0,
) -> TopologySchedule:
    rng = np.random.default_rng(seed)
    p = np.asarray(probabilities, dtype=np.float64)
    B = (rng.random((num_iterations, len(matchings))) < p[None, :]).astype(np.uint8)
    return TopologySchedule(B, tuple(matchings), "matcha")


def vanilla_schedule(
    matchings: Sequence[Graph], num_iterations: int
) -> TopologySchedule:
    B = np.ones((num_iterations, len(matchings)), dtype=np.uint8)
    return TopologySchedule(B, tuple(matchings), "vanilla")


def periodic_schedule(
    matchings: Sequence[Graph], comm_budget: float, num_iterations: int
) -> TopologySchedule:
    """P-DecenSGD: all matchings together, every round(1/CB) iterations."""
    if not 0.0 < comm_budget <= 1.0:
        raise ValueError("P-DecenSGD needs CB in (0, 1]")
    period = max(1, int(round(1.0 / comm_budget)))
    B = np.zeros((num_iterations, len(matchings)), dtype=np.uint8)
    B[::period, :] = 1
    return TopologySchedule(B, tuple(matchings), "periodic")
