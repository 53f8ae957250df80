"""MATCHA core: matching decomposition sampling for decentralized SGD.

Public API:
    Graph, named_graph, paper_figure1_graph ...  (graphs)
    matching_decomposition, matching_permutation (matching)
    optimize_activation_probabilities            (budget, paper eq. 4)
    optimize_alpha, spectral_norm_rho            (alpha, paper Lemma 1)
    TopologySchedule + matcha/vanilla/periodic   (topology)
    mixing_matrix, vanilla_equal_weight_matrix   (mixing, paper eq. 5)
    exact_rho, exact_expected_gram ...           (mixing, paper eq. 86-87)
    plan_matcha / plan_vanilla / plan_periodic   (matcha orchestrator)
    verify_spectral                              (plan-time Theorem 2 gate)
"""
from repro_torch.core.alpha import AlphaSolution, optimize_alpha, spectral_norm_rho
from repro_torch.core.budget import (
    BudgetSolution,
    expected_laplacians,
    optimize_activation_probabilities,
    project_capped_simplex,
)
from repro_torch.core.graphs import (
    Graph,
    complete_graph,
    erdos_renyi_graph,
    hypercube_graph,
    named_graph,
    paper_figure1_graph,
    random_geometric_graph,
    ring_graph,
    star_graph,
    torus_graph,
)
from repro_torch.core.matcha import (
    MatchaPlan,
    effective_activation_probs,
    plan_matcha,
    plan_periodic,
    plan_vanilla,
    verify_spectral,
)
from repro_torch.core.matching import (
    matching_decomposition,
    matching_permutation,
    misra_gries_coloring,
)
from repro_torch.core.mixing import (
    analytic_expected_gram,
    check_doubly_stochastic,
    empirical_rho,
    exact_expected_gram,
    exact_rho,
    expectation_support_connected,
    mixing_matrix,
    schedule_mixing_matrix,
    vanilla_equal_weight_matrix,
)
from repro_torch.core.topology import (
    TopologySchedule,
    matcha_schedule,
    periodic_schedule,
    vanilla_schedule,
)

__all__ = [
    "AlphaSolution",
    "BudgetSolution",
    "Graph",
    "MatchaPlan",
    "TopologySchedule",
    "analytic_expected_gram",
    "check_doubly_stochastic",
    "complete_graph",
    "effective_activation_probs",
    "empirical_rho",
    "erdos_renyi_graph",
    "exact_expected_gram",
    "exact_rho",
    "expectation_support_connected",
    "expected_laplacians",
    "hypercube_graph",
    "matcha_schedule",
    "matching_decomposition",
    "matching_permutation",
    "misra_gries_coloring",
    "mixing_matrix",
    "named_graph",
    "optimize_activation_probabilities",
    "optimize_alpha",
    "paper_figure1_graph",
    "periodic_schedule",
    "plan_matcha",
    "plan_periodic",
    "plan_vanilla",
    "project_capped_simplex",
    "random_geometric_graph",
    "ring_graph",
    "schedule_mixing_matrix",
    "spectral_norm_rho",
    "star_graph",
    "torus_graph",
    "vanilla_equal_weight_matrix",
    "vanilla_schedule",
    "verify_spectral",
]
