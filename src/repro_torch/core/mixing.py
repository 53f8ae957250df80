"""Mixing matrices W^(k) = I - alpha * L^(k) (paper eq. 5).

Symmetric and doubly stochastic by construction (row sums: L 1 = 0).
Provides both the per-iteration dense matrices (reference semantics and
the small-scale simulator) and static vanilla-DecenSGD matrices with
the classical equal-weight rule.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.graphs import Graph
from repro_torch.core.topology import TopologySchedule


def mixing_matrix(laplacian: np.ndarray, alpha: float) -> np.ndarray:
    m = laplacian.shape[0]
    return np.eye(m) - alpha * laplacian


def schedule_mixing_matrix(
    schedule: TopologySchedule, k: int, alpha: float
) -> np.ndarray:
    return mixing_matrix(schedule.laplacian(k), alpha)


def vanilla_equal_weight_matrix(graph: Graph) -> np.ndarray:
    """W = I - L / (Delta + 1): the standard equal-neighbor-weight gossip
    matrix for static DecenSGD (guaranteed doubly stochastic, PSD-safe)."""
    return mixing_matrix(graph.laplacian(), 1.0 / (graph.max_degree() + 1))


def check_doubly_stochastic(W: np.ndarray, atol: float = 1e-9) -> bool:
    m = W.shape[0]
    ones = np.ones(m)
    return (
        np.allclose(W, W.T, atol=atol)
        and np.allclose(W @ ones, ones, atol=atol)
        and np.allclose(ones @ W, ones, atol=atol)
    )


def empirical_rho(
    Ws: Sequence[np.ndarray],
) -> float:
    """Monte-Carlo estimate of rho = || E[W'W] - J ||_2 from samples."""
    m = Ws[0].shape[0]
    acc = np.zeros((m, m))
    for W in Ws:
        acc += W.T @ W
    acc /= len(Ws)
    J = np.full((m, m), 1.0 / m)
    return float(np.max(np.abs(np.linalg.eigvalsh(acc - J))))


# ---------------------------------------------------------------------------
# Exact E[W'W] over the matching-activation Bernoullis (paper eq. 86-87)
# ---------------------------------------------------------------------------
def analytic_expected_gram(
    L_bar: np.ndarray, L_tilde: np.ndarray, alpha: float
) -> np.ndarray:
    """E[W'W] = (I - alpha L_bar)^2 + 2 alpha^2 L_tilde (paper eq. 86-87).

    Exact, not an approximation: the activations B_j ~ Bernoulli(p_j)
    are independent, B_j^2 = B_j, and a matching Laplacian satisfies
    L_j^2 = 2 L_j (each edge block is 2x its own projector), which
    collapses the quadratic E[(sum_j B_j L_j)^2] to the L_bar / L_tilde
    form. Valid ONLY for independent activations — periodic schedules
    correlate rounds and must not use this.
    """
    m = L_bar.shape[0]
    W_bar = np.eye(m) - alpha * L_bar
    return W_bar @ W_bar + 2.0 * alpha**2 * L_tilde


def exact_expected_gram(
    laplacians: Sequence[np.ndarray],
    probabilities: np.ndarray,
    alpha: float,
    *,
    max_enumerate: int = 12,
) -> np.ndarray:
    """E[W'W] by direct enumeration of all 2^M activation patterns.

    For M <= ``max_enumerate`` matchings this sums W_S' W_S * P(S) over
    every activation subset S — the definition of the expectation, with
    no algebraic identities in the way. Above that it falls back to
    :func:`analytic_expected_gram`, which is equal (not approximate) for
    independent Bernoulli activations; the enumeration path exists to
    cross-validate that identity, not to replace it.
    """
    p = np.asarray(probabilities, dtype=float)
    M = len(laplacians)
    if M != p.shape[0]:
        raise ValueError("probabilities must align with laplacians")
    # NaN-safe range check: `p < lo or p > hi` is False for NaN, which
    # would let a poisoned probability vector reach the 2^M enumeration
    if not np.all((p >= -1e-12) & (p <= 1 + 1e-12)):
        raise ValueError(
            "activation probabilities must be finite and lie in [0, 1]; "
            f"got {p!r}"
        )
    m = laplacians[0].shape[0]
    if M > max_enumerate:
        L_bar = sum(pj * Lj for pj, Lj in zip(p, laplacians))
        L_tilde = sum(pj * (1 - pj) * Lj for pj, Lj in zip(p, laplacians))
        return analytic_expected_gram(L_bar, L_tilde, alpha)
    acc = np.zeros((m, m))
    eye = np.eye(m)
    for bits in range(1 << M):
        prob = 1.0
        L = np.zeros((m, m))
        for j in range(M):
            if bits >> j & 1:
                prob *= p[j]
                L = L + laplacians[j]
            else:
                prob *= 1.0 - p[j]
        if prob == 0.0:
            continue
        W = eye - alpha * L
        acc += prob * (W.T @ W)
    return acc


def exact_rho(
    laplacians: Sequence[np.ndarray],
    probabilities: np.ndarray,
    alpha: float,
    *,
    max_enumerate: int = 12,
) -> float:
    """Exact rho = || E[W'W] - J ||_2 for independent matching
    activations (Theorem 2's convergence contraction factor)."""
    m = laplacians[0].shape[0]
    gram = exact_expected_gram(
        laplacians, probabilities, alpha, max_enumerate=max_enumerate
    )
    J = np.full((m, m), 1.0 / m)
    return float(np.max(np.abs(np.linalg.eigvalsh(gram - J))))


def expectation_support_connected(
    laplacians: Sequence[np.ndarray],
    probabilities: np.ndarray,
    *,
    tol: float = 1e-9,
) -> bool:
    """Is the union of matchings with p_j > 0 a connected graph?

    Necessary for rho < 1: if the expectation graph is disconnected,
    E[W'W] - J has a second unit eigenvalue (one indicator vector per
    component) and the consensus error cannot contract.
    """
    p = np.asarray(probabilities, dtype=float)
    L = sum(
        (Lj for pj, Lj in zip(p, laplacians) if pj > tol),
        start=np.zeros_like(laplacians[0]),
    )
    lam = np.linalg.eigvalsh(L)
    return bool(lam[1] > tol)
