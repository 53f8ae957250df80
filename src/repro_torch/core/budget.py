"""Step 2 of MATCHA: matching activation probabilities.

Solves the paper's convex program (eq. 4)

    max_{p}  lambda_2( sum_j p_j L_j )
    s.t.     sum_j p_j <= CB * M,   0 <= p_j <= 1

by projected supergradient ascent. lambda_2 is concave in p; a
supergradient is given by  d lambda_2 / d p_j = v2' L_j v2  where v2 is
the Fiedler vector of sum_j p_j L_j (exact when lambda_2 is simple, a
valid supergradient element in general). The feasible set is a box
intersected with a budget half-space; projection is computed exactly by
bisection on the KKT multiplier (capped-simplex projection).

No external convex solver is required; the solution is validated in
tests against scipy's SLSQP and against the analytic optimum on
symmetric graphs.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.graphs import Graph


def _lambda2_and_fiedler(L: np.ndarray) -> tuple[float, np.ndarray]:
    lam, V = np.linalg.eigh(L)
    return float(lam[1]), V[:, 1]


def project_capped_simplex(p: np.ndarray, budget: float) -> np.ndarray:
    """Euclidean projection onto {0 <= p <= 1, sum(p) <= budget}."""
    q = np.clip(p, 0.0, 1.0)
    if q.sum() <= budget + 1e-12:
        return q
    # Find tau >= 0 with sum(clip(p - tau, 0, 1)) == budget by bisection.
    lo, hi = 0.0, float(np.max(p))
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        s = np.clip(p - mid, 0.0, 1.0).sum()
        if s > budget:
            lo = mid
        else:
            hi = mid
    return np.clip(p - hi, 0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class BudgetSolution:
    probabilities: np.ndarray      # p_j per matching
    lambda2: float                 # algebraic connectivity of expected graph
    budget: float                  # CB * M actually allowed
    iterations: int


def optimize_activation_probabilities(
    matchings: Sequence[Graph],
    comm_budget: float,
    *,
    steps: int = 2000,
    step_size: float = 0.5,
    tol: float = 1e-9,
    seed: int = 0,
) -> BudgetSolution:
    """MATCHA eq. (4). ``comm_budget`` is CB in [0, 1]."""
    if not 0.0 <= comm_budget <= 1.0:
        raise ValueError(f"CB must be in [0,1], got {comm_budget}")
    M = len(matchings)
    if M == 0:
        raise ValueError("no matchings")
    laplacians = np.stack([sg.laplacian() for sg in matchings])  # (M, m, m)
    budget = comm_budget * M

    if comm_budget >= 1.0 - 1e-12:
        # Everything active every iteration: vanilla DecenSGD.
        p = np.ones(M)
        lam2, _ = _lambda2_and_fiedler(np.tensordot(p, laplacians, axes=1))
        return BudgetSolution(p, lam2, budget, 0)

    rng = np.random.default_rng(seed)
    # Feasible warm start: uniform CB on every matching (the paper's
    # Theorem-2 feasibility witness p_j = CB).
    p = np.full(M, comm_budget)
    best_p, best_val = p.copy(), -np.inf
    for it in range(1, steps + 1):
        L = np.tensordot(p, laplacians, axes=1)
        lam2, v2 = _lambda2_and_fiedler(L)
        if lam2 > best_val:
            best_val, best_p = lam2, p.copy()
        grad = np.einsum("i,jik,k->j", v2, laplacians, v2)  # v2' L_j v2
        gnorm = np.linalg.norm(grad)
        if gnorm < tol:
            break
        # Diminishing step (standard for subgradient methods), small
        # random perturbation breaks eigenvalue-crossing plateaus.
        step = step_size / np.sqrt(it)
        p_new = p + step * grad / max(gnorm, 1e-12)
        if it % 50 == 0:
            p_new = p_new + rng.normal(scale=1e-4, size=M)
        p_new = project_capped_simplex(p_new, budget)
        if np.linalg.norm(p_new - p) < tol:
            p = p_new
            break
        p = p_new
    L = np.tensordot(best_p, laplacians, axes=1)
    lam2, _ = _lambda2_and_fiedler(L)
    return BudgetSolution(best_p, lam2, budget, it)


def expected_laplacians(
    matchings: Sequence[Graph], probabilities: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """(L_bar, L_tilde) from Lemma 1: sum p_j L_j and sum p_j(1-p_j) L_j."""
    Ls = np.stack([sg.laplacian() for sg in matchings])
    p = np.asarray(probabilities, dtype=np.float64)
    L_bar = np.tensordot(p, Ls, axes=1)
    L_tilde = np.tensordot(p * (1.0 - p), Ls, axes=1)
    return L_bar, L_tilde
