"""Schedule-level verifier: Theorem 2's convergence condition, checked.

The port's copy of ``repro.analysis.schedule`` (numpy only), over the
port's own ``repro_torch.core`` and ``repro_torch.faults``. The kernels
are covered by ``kernel_lint`` and the traced steps by ``check``;
*above* the step — does the sampled topology sequence actually contract
the consensus error? — is covered here. The contraction factor
is rho = || E[W(k)' W(k)] - J ||_2 over the plan's matching-activation
Bernoullis, and Theorem 2 requires rho < 1. These checks recompute that
expectation exactly (``repro_torch.core.mixing.exact_rho``: 2^M enumeration
for small M, the eq. 86-87 closed form otherwise — both exact for
independent activations) and verify, returning
:class:`repro_torch.analysis.checks.Violation` records:

* :func:`check_plan_spectral` — the plan's expectation graph is
  connected (``expectation-graph-disconnected``), the exact rho is < 1
  (``schedule-rho-not-contractive``), and the rho the optimizer stored
  in the plan is the exact one (``plan-rho-mismatch``);
* :func:`check_empirical_rho` — a sampled schedule's Monte-Carlo
  mixing-matrix average (``repro_torch.core.mixing.empirical_rho``) agrees
  with the exact expectation (``empirical-rho-mismatch``): the sampler
  draws from the distribution the plan optimized;
* :func:`check_spectral_csv` — the committed
  ``benchmarks/results/spectral_norm_vs_budget.csv`` re-derives from
  today's planner (``spectral-csv-mismatch``): the figure-3 artifact is
  only citable while the code still produces it;
* :func:`check_faulted_spectral` — Theorem 2 re-verified under
  injected link drops (``docs/fault_model.md``): activation Bernoullis
  rescale to p_eff = p * (1 - p_drop) — exact, not approximate, because
  same-matching edge Laplacians annihilate — and the degraded plan must
  still contract (``faulted-support-disconnected``,
  ``faulted-rho-not-contractive``);
* :func:`check_degraded_mixing` — the fault schedule's per-node gates
  actually preserve the mixing invariant: every sampled faulted step's
  effective W is symmetric and doubly stochastic
  (``degraded-w-not-doubly-stochastic``), i.e. a dropped exchange
  renormalizes self-weight at BOTH endpoints instead of leaking
  consensus mass.

Pure numpy: it imports neither torch nor jax.
"""

from __future__ import annotations

import csv
import os

from repro_torch.analysis.checks import Violation

__all__ = [
    "CSV_GRAPHS",
    "SPECTRAL_CSV",
    "check_degraded_mixing",
    "check_empirical_rho",
    "check_faulted_spectral",
    "check_plan_spectral",
    "check_spectral_csv",
]

SPECTRAL_CSV = os.path.join(
    "benchmarks", "results", "spectral_norm_vs_budget.csv"
)

# graph column -> named_graph(key, m, seed=3); must mirror
# benchmarks/bench_spectral.GRAPHS (the producer of the committed CSV)
CSV_GRAPHS = {
    "paper8_fig1": ("paper8", 8),
    "geometric16_dense": ("geometric-dense", 16),
    "erdos_renyi16": ("erdos-renyi", 16),
}
CSV_BUDGET_STEPS = 1200


def _plan_laplacians(plan):
    return [sg.laplacian() for sg in plan.matchings]


def check_plan_spectral(plan, *, rho_tol: float = 1e-6,
                        where: str = "plan") -> list:
    """Theorem 2 gate on one :class:`repro_torch.core.MatchaPlan`.

    Mirrors ``repro_torch.core.matcha.verify_spectral`` but reports instead
    of raising, so the CLI can show every violation in one JSON run —
    and so a plan built behind the planner's back (or with the in-plan
    gate monkey-patched out) still fails ``analysis.check --strict``.
    """
    from repro_torch.core.mixing import exact_rho, expectation_support_connected

    out = []
    laplacians = _plan_laplacians(plan)
    if not expectation_support_connected(laplacians, plan.probabilities):
        out.append(Violation(
            "expectation-graph-disconnected",
            "the union of matchings with p_j > 0 is disconnected — "
            "E[W'W] - J keeps a unit eigenvalue per component and the "
            "consensus error cannot contract (rho >= 1)",
            where,
        ))
    rho = exact_rho(laplacians, plan.probabilities, plan.alpha)
    # margin for eigvalsh rounding a unit eigenvalue to 1 - O(eps); no
    # real plan sits within 1e-9 of the boundary
    if rho >= 1.0 - 1e-9:
        out.append(Violation(
            "schedule-rho-not-contractive",
            f"exact rho = {rho:.6f} >= 1: Theorem 2's convergence "
            "condition fails for this plan",
            where,
        ))
    if abs(rho - plan.rho) > rho_tol:
        out.append(Violation(
            "plan-rho-mismatch",
            f"plan.rho = {plan.rho:.8f} but the exact E[W'W] spectral "
            f"norm is {rho:.8f} (tol {rho_tol:g}) — the optimizer's "
            "reported contraction factor is not the real one",
            where,
        ))
    return out


def check_empirical_rho(
    plan,
    *,
    num_iterations: int = 3000,
    seed: int = 0,
    tol: float = 0.05,
    where: str = "plan",
) -> list:
    """The schedule sampler draws from the optimized distribution.

    Samples ``num_iterations`` topology rounds with the production
    sampler (``plan.schedule``), averages their W'W, and compares the
    Monte-Carlo rho against the exact expectation. The tolerance covers
    O(1/sqrt(n)) sampling noise at the fixed seed; a sampler that
    ignores the plan probabilities (or activates the wrong matchings)
    lands far outside it.
    """
    from repro_torch.core.mixing import (
        empirical_rho,
        exact_rho,
        schedule_mixing_matrix,
    )

    sched = plan.schedule(num_iterations, seed=seed)
    Ws = [
        schedule_mixing_matrix(sched, k, plan.alpha)
        for k in range(num_iterations)
    ]
    emp = empirical_rho(Ws)
    exact = exact_rho(
        _plan_laplacians(plan), plan.probabilities, plan.alpha
    )
    if abs(emp - exact) > tol:
        return [Violation(
            "empirical-rho-mismatch",
            f"empirical rho {emp:.4f} over {num_iterations} sampled "
            f"rounds (seed {seed}) vs exact {exact:.4f} — "
            f"|diff| > {tol}: the sampler is not drawing from the "
            "plan's activation distribution",
            where,
        )]
    return []


def check_faulted_spectral(plan, p_drop: float, *,
                           where: str = "plan") -> list:
    """Theorem 2 under injected link drops.

    Rescales the plan's activation Bernoullis to the faulted
    ``p_eff = p * (1 - p_drop)`` (exact at matching granularity:
    same-matching edges have vertex-disjoint supports, so their
    Laplacian cross terms in E[W'W] vanish — ``docs/fault_model.md``)
    and re-runs the contraction gate on the degraded distribution. This
    is the analysis-side mirror of ``repro_torch.faults.verify_degraded_plan``
    / the training CLI's ``--strict-faults``: a drop rate that disconnects the
    effective support or pushes rho to 1 means the faulted run can no
    longer contract its consensus error, no matter the step count.
    """
    from repro_torch.core.matcha import effective_activation_probs
    from repro_torch.core.mixing import exact_rho, expectation_support_connected

    out = []
    p_eff = effective_activation_probs(plan, p_drop)
    laplacians = _plan_laplacians(plan)
    if not expectation_support_connected(laplacians, p_eff):
        out.append(Violation(
            "faulted-support-disconnected",
            f"at p_drop = {p_drop:g} the union of matchings with "
            "p_eff > 0 is disconnected — the degraded consensus error "
            "cannot contract (rho >= 1); lower the drop rate or raise "
            "the communication budget",
            where,
        ))
    rho = exact_rho(laplacians, p_eff, plan.alpha)
    if rho >= 1.0 - 1e-9:
        out.append(Violation(
            "faulted-rho-not-contractive",
            f"exact rho under p_drop = {p_drop:g} is {rho:.6f} >= 1: "
            "Theorem 2's convergence condition fails for the degraded "
            "plan",
            where,
        ))
    return out


def check_degraded_mixing(
    plan,
    *,
    p_drop: float = 0.3,
    num_iterations: int = 50,
    seed: int = 0,
    tol: float = 1e-9,
    where: str = "plan",
) -> list:
    """Faulted steps keep the mixing invariant, numerically.

    Builds a seeded :class:`repro_torch.faults.FaultSchedule`, samples
    ``num_iterations`` activation rounds with the production sampler,
    and assembles every step's *effective* mixing matrix from the
    per-node gate rows the runtime would hand the gossip step
    (``repro_torch.faults.effective_mixing_matrix``). Each W must be
    symmetric with unit row/column sums: the degradation rule is
    self-weight renormalization at BOTH endpoints of a dropped link, so
    any asymmetry or leaked consensus mass here means the fault model
    (or a mutation of its drop-propagation) broke doubly stochastic
    mixing — the property Theorem 2's contraction argument rests on.
    """
    import numpy as np

    from repro_torch.faults import (
        FaultSpec, effective_mixing_matrix, make_fault_schedule,
    )

    spec = FaultSpec(p_drop=p_drop, seed=seed)
    sched = make_fault_schedule(plan, num_iterations, spec)
    topo = plan.schedule(num_iterations, seed=seed)
    m = sched.num_nodes
    ones = np.ones(m)
    for k in range(num_iterations):
        bits = sched.node_bits(topo.activations[k], k)   # (nodes, M)
        W = effective_mixing_matrix(
            np.asarray(plan.permutations), plan.alpha, bits
        )
        asym = float(np.max(np.abs(W - W.T)))
        row_err = float(np.max(np.abs(W @ ones - ones)))
        if asym > tol or row_err > tol:
            return [Violation(
                "degraded-w-not-doubly-stochastic",
                f"faulted step {k} (p_drop={p_drop:g}, seed {seed}): "
                f"effective W has asymmetry {asym:.2e} / row-sum error "
                f"{row_err:.2e} (> {tol:g}) — a dropped exchange is not "
                "renormalizing self-weight symmetrically at both "
                "endpoints, so consensus mass leaks",
                where,
            )]
    return []


def check_spectral_csv(
    path: str = SPECTRAL_CSV, *, tol: float = 5e-5, where: str = ""
) -> list:
    """Re-derive the committed Fig.-3 CSV from the current planner.

    For every row, rebuilds the MATCHA plan exactly as
    ``benchmarks/bench_spectral`` does (same graph seed, same budget
    steps — the pipeline is deterministic) and compares the exact rho
    against the committed ``rho_matcha``/``rho_vanilla``/
    ``rho_periodic`` columns at the CSV's rounding precision.
    """
    from repro_torch.core import (
        named_graph,
        plan_matcha,
        plan_periodic,
        plan_vanilla,
    )
    from repro_torch.core.mixing import exact_rho

    where = where or path
    if not os.path.exists(path):
        return [Violation(
            "spectral-csv-mismatch",
            f"committed spectral artifact {path} is missing",
            where,
        )]
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return [Violation(
            "spectral-csv-mismatch", f"{path} has no data rows", where
        )]
    out = []
    vanilla_cache: dict = {}
    for row in rows:
        gname = row["graph"]
        if gname not in CSV_GRAPHS:
            out.append(Violation(
                "spectral-csv-mismatch",
                f"unknown graph column {gname!r} — not producible by "
                "bench_spectral",
                where,
            ))
            continue
        key, m = CSV_GRAPHS[gname]
        g = named_graph(key, m, seed=3)
        cb = float(row["cb"])
        mp = plan_matcha(g, cb, budget_steps=CSV_BUDGET_STEPS)
        got = exact_rho(
            _plan_laplacians(mp), mp.probabilities, mp.alpha
        )
        want = float(row["rho_matcha"])
        if abs(got - want) > tol:
            out.append(Violation(
                "spectral-csv-mismatch",
                f"{gname} CB={cb}: recomputed exact rho {got:.5f} vs "
                f"committed rho_matcha {want:.5f}",
                where,
            ))
        if gname not in vanilla_cache:
            vanilla_cache[gname] = plan_vanilla(g).rho
        want_v = float(row["rho_vanilla"])
        if abs(vanilla_cache[gname] - want_v) > tol:
            out.append(Violation(
                "spectral-csv-mismatch",
                f"{gname}: recomputed rho_vanilla "
                f"{vanilla_cache[gname]:.5f} vs committed {want_v:.5f}",
                where,
            ))
        pp, _sched = plan_periodic(g, cb)
        want_p = float(row["rho_periodic"])
        if abs(pp.rho - want_p) > tol:
            out.append(Violation(
                "spectral-csv-mismatch",
                f"{gname} CB={cb}: recomputed rho_periodic "
                f"{pp.rho:.5f} vs committed {want_p:.5f}",
                where,
            ))
    return out
