"""MATCHA orchestrator: graph + budget -> (matchings, p, alpha, rho, schedule).

This is the paper's full pipeline (Sections 3.1-3.3) behind one call,
and the single entry point the distributed runtime consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.alpha import AlphaSolution, optimize_alpha
from repro_torch.core.budget import (
    BudgetSolution,
    expected_laplacians,
    optimize_activation_probabilities,
)
from repro_torch.core.graphs import Graph
from repro_torch.core.matching import (
    matching_decomposition,
    matching_permutation,
    validate_permutations,
)
from repro_torch.core.mixing import exact_rho, expectation_support_connected
from repro_torch.core.topology import (
    TopologySchedule,
    matcha_schedule,
    periodic_schedule,
)


@dataclasses.dataclass(frozen=True)
class MatchaPlan:
    """Everything needed to run decentralized SGD with MATCHA.

    Computed once, before training (the paper's 'apriori' property).
    """

    graph: Graph
    matchings: Tuple[Graph, ...]
    permutations: np.ndarray          # (M, m) involutions, for ppermute
    probabilities: np.ndarray         # (M,)
    alpha: float
    rho: float                        # exact spectral norm of E[W'W] - J
    lambda2: float                    # algebraic connectivity of E[L]
    comm_budget: float

    def __post_init__(self):
        # Plan-time validation instead of trusting the sampler: every
        # schedule row ppermutes with one of these permutations, so a
        # non-involution here would silently corrupt the mixing step.
        validate_permutations(self.permutations, self.graph.m)
        # Edge validation of the activation probabilities (NaN-safe:
        # a poisoned optimizer output must fail here with a clear
        # message, not deep inside the 2^M spectral enumeration).
        p = np.asarray(self.probabilities, dtype=float)
        if p.shape != (len(self.matchings),):
            raise ValueError(
                f"probabilities shape {p.shape} does not match the "
                f"{len(self.matchings)} matchings"
            )
        if not np.all((p >= 0.0) & (p <= 1.0)):
            raise ValueError(
                "activation probabilities must be finite and lie in "
                f"[0, 1]; got {p!r}"
            )

    @property
    def num_matchings(self) -> int:
        return len(self.matchings)

    def ppermute_pairs(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """Per matching, the exact ``(source, dest)`` pairs its gossip
        exchange is issued with (fixed points map to themselves).  Node
        ``d`` receives from ``p[d]``: the gather ``x[p]`` along the node
        dim in ``repro_torch.dist.gossip``."""
        return tuple(
            tuple((i, int(p[i])) for i in range(self.graph.m))
            for p in np.asarray(self.permutations)
        )

    @property
    def expected_comm_units(self) -> float:
        """Expected per-iteration communication delay (paper eq. 3)."""
        return float(self.probabilities.sum())

    @property
    def vanilla_comm_units(self) -> int:
        """Per-iteration delay of vanilla DecenSGD: all M matchings."""
        return self.num_matchings

    def schedule(self, num_iterations: int, seed: int = 0) -> TopologySchedule:
        return matcha_schedule(
            self.matchings, self.probabilities, num_iterations, seed
        )


def verify_spectral(plan: MatchaPlan, *, rho_tol: float = 1e-6) -> float:
    """Plan-time gate on Theorem 2's convergence condition.

    Recomputes rho = || E[W'W] - J ||_2 exactly over the plan's
    independent matching-activation Bernoullis (2^M enumeration for
    small M, the eq. 86-87 closed form otherwise — both exact) and
    raises if the plan cannot contract:

    * the expectation graph (union of matchings with p_j > 0) is
      disconnected — rho >= 1 no matter what alpha is;
    * the exact rho is >= 1;
    * ``plan.rho`` disagrees with the exact value by more than
      ``rho_tol`` — the optimizer's reported rho must be the real one,
      not an artifact of its parametrization.

    Only valid for plans whose schedule samples matchings independently
    per iteration (plan_matcha / plan_vanilla). plan_periodic correlates
    rounds and is gated by its own closed form instead.
    Returns the exact rho.
    """
    laplacians = [sg.laplacian() for sg in plan.matchings]
    if not expectation_support_connected(laplacians, plan.probabilities):
        raise ValueError(
            "expectation graph disconnected: the union of matchings with "
            "p_j > 0 must be connected for rho < 1 (Theorem 2)"
        )
    rho = exact_rho(laplacians, plan.probabilities, plan.alpha)
    # a unit eigenvalue can round to 1 - O(eps) in eigvalsh; no real
    # plan sits within 1e-9 of the boundary, so compare with margin
    if rho >= 1.0 - 1e-9:
        raise ValueError(
            f"plan is not contractive: exact rho = {rho:.6f} >= 1 "
            "(Theorem 2 requires rho < 1)"
        )
    if abs(rho - plan.rho) > rho_tol:
        raise ValueError(
            f"plan.rho = {plan.rho:.8f} disagrees with the exact "
            f"E[W'W] spectral norm {rho:.8f} (tol {rho_tol:g})"
        )
    return rho


def effective_activation_probs(plan: MatchaPlan, fault_model) -> np.ndarray:
    """Activation probabilities under i.i.d. per-edge link drops.

    ``fault_model`` is anything with a ``p_drop`` attribute or a bare
    drop probability. Returns
    ``p_eff_j = p_j * (1 - p_drop)``.

    This matching-granularity rescaling is *exact* for the spectral
    analysis, not an approximation: edges within one matching have
    vertex-disjoint supports, so their Laplacians annihilate each other
    (``L_e L_f = 0`` for ``e != f`` in the same matching) and every
    same-matching cross term in ``E[W'W]`` vanishes — the expectation
    under per-edge Bernoulli(1 - p_drop) survival equals the
    independent-matching closed form evaluated at ``p_eff`` (derivation
    in ``docs/fault_model.md``). Feed the result to ``exact_rho`` /
    ``verify`` paths to gate Theorem 2 under faults.
    """
    p_drop = getattr(fault_model, "p_drop", fault_model)
    pd = float(p_drop)
    if not np.isfinite(pd) or not 0.0 <= pd <= 1.0:
        raise ValueError(
            f"p_drop must be a finite probability in [0, 1], got {p_drop!r}"
        )
    return np.asarray(plan.probabilities, dtype=float) * (1.0 - pd)


def plan_matcha(
    graph: Graph,
    comm_budget: float,
    *,
    budget_steps: int = 2000,
    seed: int = 0,
) -> MatchaPlan:
    """Run MATCHA Steps 1-3 for ``graph`` at communication budget CB."""
    cb = float(comm_budget)
    # NaN-safe edge validation (`not 0 < cb <= 1` catches NaN too): the
    # budget feeds the activation-probability optimizer, and a bad value
    # would otherwise surface as an opaque spectral failure much later
    if not 0.0 < cb <= 1.0:
        raise ValueError(
            "comm_budget must be a finite fraction in (0, 1] of the "
            f"vanilla per-iteration communication, got {comm_budget!r}"
        )
    if not graph.is_connected():
        raise ValueError("MATCHA requires a connected base graph (Theorem 2)")
    matchings = matching_decomposition(graph)
    sol: BudgetSolution = optimize_activation_probabilities(
        matchings, comm_budget, steps=budget_steps, seed=seed
    )
    L_bar, L_tilde = expected_laplacians(matchings, sol.probabilities)
    asol: AlphaSolution = optimize_alpha(L_bar, L_tilde)
    perms = np.stack([matching_permutation(sg) for sg in matchings])
    plan = MatchaPlan(
        graph=graph,
        matchings=tuple(matchings),
        permutations=perms,
        probabilities=sol.probabilities,
        alpha=asol.alpha,
        rho=asol.rho,
        lambda2=sol.lambda2,
        comm_budget=comm_budget,
    )
    verify_spectral(plan)
    return plan


def plan_vanilla(graph: Graph) -> MatchaPlan:
    """Vanilla DecenSGD expressed in the same plan format (p_j = 1)."""
    matchings = matching_decomposition(graph)
    p = np.ones(len(matchings))
    L_bar, L_tilde = expected_laplacians(matchings, p)   # L_tilde = 0
    asol = optimize_alpha(L_bar, L_tilde)
    perms = np.stack([matching_permutation(sg) for sg in matchings])
    lam = np.linalg.eigvalsh(L_bar)
    plan = MatchaPlan(
        graph=graph,
        matchings=tuple(matchings),
        permutations=perms,
        probabilities=p,
        alpha=asol.alpha,
        rho=asol.rho,
        lambda2=float(lam[1]),
        comm_budget=1.0,
    )
    verify_spectral(plan)
    return plan


def plan_periodic(
    graph: Graph, comm_budget: float
) -> tuple[MatchaPlan, "TopologySchedule"]:
    """P-DecenSGD baseline: same plan shape; schedule built separately.

    rho for P-DecenSGD: W^(k) alternates between W_full (with its own
    optimal alpha) and I. E[W'W] = q * W_full'W_full + (1-q) * I with
    q = 1/period; we reuse spectral_norm machinery by computing it
    directly here.
    """
    matchings = matching_decomposition(graph)
    period = max(1, int(round(1.0 / comm_budget)))
    q = 1.0 / period
    m = graph.m
    L = graph.laplacian()
    # Optimize alpha for the periodic scheme exactly: E[W'W] - J =
    # q (I - aL)^2 + (1-q) I - J; minimize its spectral norm over a.
    import numpy.linalg as npl

    lam, V = npl.eigh(L)
    J = np.full((m, m), 1.0 / m)

    def rho_of(a: float) -> float:
        W = np.eye(m) - a * L
        E = q * (W @ W) + (1 - q) * np.eye(m)
        return float(np.max(np.abs(npl.eigvalsh(E - J))))

    # golden-section over a in (0, 2/lam_max)
    lo, hi = 0.0, 2.0 / float(lam[-1])
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = rho_of(c), rho_of(d)
    for _ in range(200):
        if abs(b - a) < 1e-12:
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = rho_of(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = rho_of(d)
    alpha = 0.5 * (a + b)
    perms = np.stack([matching_permutation(sg) for sg in matchings])
    plan = MatchaPlan(
        graph=graph,
        matchings=tuple(matchings),
        permutations=perms,
        probabilities=np.full(len(matchings), q),
        alpha=float(alpha),
        rho=rho_of(float(alpha)),
        lambda2=float(lam[1]) * q,
        comm_budget=comm_budget,
    )
    return plan, periodic_schedule(matchings, comm_budget, 1)
