"""Deterministic fault model: seeded link drops, stragglers, crashes.

A copy of ``repro.faults.model`` (numpy only), pinned to it by
``tests/test_torch_faults.py``; only the imports name the port.

MATCHA's runtime (and its Theorem 2 guarantee) assumes every sampled
matching completes. This module makes failure a *first-class, a-priori*
execution axis, mirroring how the activation schedule itself works: a
:class:`FaultSchedule` is drawn once, up front, from a seeded RNG, so a
faulted run is exactly reproducible and exactly analyzable.

Fault taxonomy (see ``docs/fault_model.md``):

* **Link drops** — within an activated matching, each edge's exchange
  independently fails with probability ``p_drop``. The degraded gossip
  step keeps the effective mixing matrix symmetric and doubly
  stochastic by *self-weight renormalization*: a dropped edge's two
  endpoints both keep the weight they would have sent (the per-node
  gate is symmetric across the edge), so consensus mass is never lost.
* **Node downtime** — node ``i`` is down for steps ``[start, stop)``:
  every matching edge touching ``i`` is dropped for those steps (the
  node still takes local SGD steps in this simulation; only its
  exchanges fail).
* **Stragglers** — per-node delay spikes: node ``i`` is slow at step
  ``k`` with probability ``straggler_prob``, adding
  ``straggler_units`` to the modeled step time (gossip is a
  synchronous round, so the step takes the max over nodes).
* **Crashes** — the training CLI raises :class:`SimulatedCrash` after
  completing step ``crash_at_step``; recovery is a process restart
  with ``--resume auto`` (crash-safe checkpoints live in
  ``repro_torch.checkpoint.ckpt``).

The per-step per-node *effective activation bits*
``ebits[i, j] = B_j(k) * link_mask[k, j, i]`` enter the train step in
place of the plain schedule row; because the gate is symmetric across
each edge, the existing masked-gossip arithmetic
(``delta_i = sum_j ebits[i, j] (x_partner - x_i)``) realizes exactly

    W_eff[i, i] = 1 - alpha * sum_j ebits[i, j]
    W_eff[i, pi_j(i)] += alpha * ebits[i, j]

which is symmetric with unit row sums — doubly stochastic per step.
:func:`effective_mixing_matrix` is the dense oracle tests compare the
runtime against.

Spectrally, i.i.d. per-edge drops are *exactly* equivalent to scaling
the matching activation probabilities: edges within one matching have
vertex-disjoint Laplacians (``L_e L_f = 0``), so every same-matching
cross term in ``E[W'W]`` vanishes and the expectation equals the
independent-matching closed form evaluated at
``p_eff_j = p_j * (1 - p_drop)`` (see
``repro_torch.core.matcha.effective_activation_probs`` and the derivation in
``docs/fault_model.md``). :func:`verify_degraded_plan` re-checks
Theorem 2's contraction under those faulted Bernoullis.

Pure numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "FaultSchedule",
    "FaultSpec",
    "SimulatedCrash",
    "effective_mixing_matrix",
    "make_fault_schedule",
    "verify_degraded_plan",
]


class SimulatedCrash(RuntimeError):
    """Raised by the training CLI to simulate a node crash at a declared step.

    Carries the step index so the surrounding harness (chaos tests, the
    CLI's exit path) can report where the process died."""

    def __init__(self, step: int):
        super().__init__(
            f"simulated crash after step {step} (injected by the fault "
            "schedule; restart with --resume auto)"
        )
        self.step = int(step)


def _check_prob(name: str, value) -> float:
    v = float(value)
    if not np.isfinite(v) or not 0.0 <= v <= 1.0:
        raise ValueError(
            f"{name} must be a finite probability in [0, 1], got {value!r}"
        )
    return v


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Declaration of the faults to inject into one run.

    ``downtime`` entries are ``(node, start, stop)``: node is down for
    steps ``start <= k < stop``. ``crash_at_step = -1`` means no crash.
    All fields are validated eagerly — a NaN drop rate must fail here,
    not deep inside the spectral enumeration.
    """

    p_drop: float = 0.0
    straggler_prob: float = 0.0
    straggler_units: float = 1.0
    crash_at_step: int = -1
    downtime: Tuple[Tuple[int, int, int], ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "p_drop", _check_prob("p_drop", self.p_drop))
        object.__setattr__(
            self, "straggler_prob",
            _check_prob("straggler_prob", self.straggler_prob),
        )
        su = float(self.straggler_units)
        if not np.isfinite(su) or su < 0.0:
            raise ValueError(
                f"straggler_units must be finite and >= 0, got {su!r}"
            )
        if int(self.crash_at_step) < -1:
            raise ValueError(
                f"crash_at_step must be -1 (no crash) or a step index, "
                f"got {self.crash_at_step!r}"
            )
        norm = []
        for entry in self.downtime:
            node, start, stop = (int(x) for x in entry)
            if node < 0 or start < 0 or stop < start:
                raise ValueError(
                    f"downtime entry must be (node >= 0, start >= 0, "
                    f"stop >= start), got {entry!r}"
                )
            norm.append((node, start, stop))
        object.__setattr__(self, "downtime", tuple(norm))

    @property
    def has_link_faults(self) -> bool:
        """True when any exchange can be degraded (drops or downtime) —
        the condition for building the faulted train-step variant."""
        return self.p_drop > 0.0 or bool(self.downtime)

    @property
    def empty(self) -> bool:
        return (
            not self.has_link_faults
            and self.straggler_prob == 0.0
            and int(self.crash_at_step) < 0
        )


def _propagate_drop_to_partner(
    dropped: np.ndarray, permutations: np.ndarray
) -> np.ndarray:
    """Symmetrize per-edge drops onto both endpoints.

    ``dropped`` is (K, M, m) boolean with drops drawn only at each
    edge's lower endpoint; the returned array marks *both* endpoints of
    every dropped edge, which is what keeps the effective mixing matrix
    symmetric (each endpoint keeps its own weight — self-weight
    renormalization). The renormalization mutation test deliberately
    breaks this propagation to prove the doubly-stochastic gate catches
    leaked consensus mass.
    """
    out = dropped.copy()
    for j in range(permutations.shape[0]):
        pi = np.asarray(permutations[j])
        out[:, j, pi] |= dropped[:, j, :]
    return out


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Seeded per-iteration fault realization for one run.

    ``link_masks[k, j, i]`` is 1.0 when node ``i``'s exchange on
    matching ``j`` survives step ``k`` (symmetric across every matching
    edge, by construction); ``delays[k, i]`` is node ``i``'s straggler
    delay at step ``k`` in modeled comm units.
    """

    spec: FaultSpec
    permutations: np.ndarray        # (M, m) matching involutions
    link_masks: np.ndarray          # (K, M, m) float32 in {0, 1}
    delays: np.ndarray              # (K, m) float32

    @property
    def num_iterations(self) -> int:
        return int(self.link_masks.shape[0])

    @property
    def num_matchings(self) -> int:
        return int(self.link_masks.shape[1])

    @property
    def num_nodes(self) -> int:
        return int(self.link_masks.shape[2])

    @property
    def empty(self) -> bool:
        """No degraded exchange anywhere in the realization."""
        return bool(np.all(self.link_masks == 1.0))

    def node_bits(self, activation_row: np.ndarray, k: int) -> np.ndarray:
        """Per-node effective activation bits at step ``k``:
        ``(num_nodes, M)`` float32 with
        ``ebits[i, j] = activation_row[j] * link_masks[k, j, i]`` —
        the array the faulted train step takes in place of the plain
        ``(M,)`` schedule row."""
        row = np.asarray(activation_row, np.float32)
        if row.shape != (self.num_matchings,):
            raise ValueError(
                f"activation row shape {row.shape} does not match the "
                f"{self.num_matchings} matchings in the fault schedule"
            )
        return (row[None, :] * self.link_masks[k].T).astype(np.float32)

    def dropped_links(self, activation_row: np.ndarray, k: int) -> int:
        """Number of *activated* node-exchanges degraded at step ``k``
        (two per dropped edge, matching what each node observes)."""
        row = np.asarray(activation_row, np.float32)
        fixed = self.permutations == np.arange(self.num_nodes)[None, :]
        lost = (1.0 - self.link_masks[k]) * row[:, None]
        return int(np.sum(lost[~fixed]))

    def max_delay(self, k: int) -> float:
        """Straggler delay the synchronous round pays at step ``k``
        (max over nodes, in modeled comm units)."""
        return float(np.max(self.delays[k])) if self.num_nodes else 0.0


def make_fault_schedule(
    plan_or_permutations,
    num_iterations: int,
    spec: FaultSpec,
) -> FaultSchedule:
    """Draw the full fault realization for ``num_iterations`` steps.

    Accepts a ``repro_torch.core.MatchaPlan`` or a raw ``(M, m)`` permutation
    array. Deterministic in ``spec.seed``: the same spec and plan always
    produce the identical realization (the reproducibility contract the
    chaos tests pin)."""
    perms = np.asarray(
        getattr(plan_or_permutations, "permutations", plan_or_permutations),
        dtype=int,
    )
    if perms.ndim != 2:
        raise ValueError(
            f"permutations must be (M, m) involutions, got shape {perms.shape}"
        )
    num_matchings, m = perms.shape
    steps = int(num_iterations)
    if steps < 0:
        raise ValueError(f"num_iterations must be >= 0, got {num_iterations}")
    rng = np.random.default_rng(spec.seed)

    # per-edge drops, drawn at each edge's lower endpoint then
    # propagated to the partner (self-weight renormalization symmetry)
    lower = np.arange(m)[None, :] < perms          # (M, m)
    draws = rng.random((steps, num_matchings, m))
    dropped = (draws < spec.p_drop) & lower[None]
    dropped = _propagate_drop_to_partner(dropped, perms)
    masks = 1.0 - dropped.astype(np.float32)

    # node downtime: every matching edge touching a down node drops
    for node, start, stop in spec.downtime:
        if node >= m:
            raise ValueError(
                f"downtime node {node} out of range for {m} nodes"
            )
        lo, hi = min(start, steps), min(stop, steps)
        if lo >= hi:
            continue
        for j in range(num_matchings):
            partner = int(perms[j, node])
            if partner == node:
                continue
            masks[lo:hi, j, node] = 0.0
            masks[lo:hi, j, partner] = 0.0

    slow = rng.random((steps, m)) < spec.straggler_prob
    delays = slow.astype(np.float32) * np.float32(spec.straggler_units)
    return FaultSchedule(
        spec=spec, permutations=perms, link_masks=masks, delays=delays
    )


def effective_mixing_matrix(
    permutations: np.ndarray,
    alpha: float,
    node_bits: np.ndarray,          # (m, M) per-node effective bits
) -> np.ndarray:
    """Dense oracle for one degraded step's effective mixing matrix:

        W[i, i]        = 1 - alpha * sum_j ebits[i, j]
        W[i, pi_j(i)] += alpha * ebits[i, j]        (pi_j(i) != i)

    With edge-symmetric bits this is symmetric and doubly stochastic —
    the invariant the degraded gossip path must preserve and the
    mutation test breaks on purpose."""
    perms = np.asarray(permutations, dtype=int)
    num_matchings, m = perms.shape
    ebits = np.asarray(node_bits, np.float64)
    if ebits.shape != (m, num_matchings):
        raise ValueError(
            f"node_bits shape {ebits.shape} does not match "
            f"({m}, {num_matchings})"
        )
    W = np.eye(m)
    idx = np.arange(m)
    for j in range(num_matchings):
        pi = perms[j]
        w = float(alpha) * np.where(pi == idx, 0.0, ebits[:, j])
        W[idx, idx] -= w
        W[idx, pi] += w
    return W


def verify_degraded_plan(
    plan,
    fault_model,
    *,
    strict: bool = False,
) -> Tuple[float, Sequence[str]]:
    """Theorem 2 under the faulted Bernoullis.

    Re-evaluates the exact contraction factor at the effective
    activation probabilities ``p_eff_j = p_j * (1 - p_drop)`` (exact
    for i.i.d. per-edge drops — see module docstring) with the plan's
    *original* alpha (the runtime cannot re-optimize alpha per fault
    realization). Returns ``(rho_faulted, problems)``; with
    ``strict=True`` a non-contractive degraded plan raises instead of
    merely being reported.
    """
    from repro_torch.core.matcha import effective_activation_probs
    from repro_torch.core.mixing import exact_rho, expectation_support_connected

    p_eff = effective_activation_probs(plan, fault_model)
    laplacians = [sg.laplacian() for sg in plan.matchings]
    problems = []
    if not expectation_support_connected(laplacians, p_eff):
        problems.append(
            "faulted expectation graph disconnected: with this drop rate "
            "the union of matchings with p_eff > 0 cannot connect the "
            "nodes, so the consensus error cannot contract"
        )
    rho = exact_rho(laplacians, p_eff, plan.alpha)
    if rho >= 1.0 - 1e-9:
        p_drop = float(getattr(fault_model, "p_drop", fault_model))
        problems.append(
            f"degraded plan is not contractive: exact rho = {rho:.6f} >= 1 "
            f"at p_drop = {p_drop:g} (Theorem 2 requires rho < 1; lower "
            "the drop rate or raise the communication budget)"
        )
    if strict and problems:
        raise ValueError("; ".join(problems))
    return float(rho), problems
