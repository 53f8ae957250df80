"""A frozen numpy copy of the MATCHA planner, for the reference.

The reference works out the plan and its schedule again rather than
take them from the program: the base graph, its matching decomposition
(Misra & Gries edge colouring, matchings ordered densest first), the
activation probabilities (projected supergradient ascent on lambda_2,
paper eq. 4), the mixing weight alpha (exact 1-D minimisation of rho,
Lemma 1) and the a-priori Bernoulli schedule. The arithmetic follows the
port's ``repro_torch.core`` step for step, so both give the same plan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np

Edge = Tuple[int, int]

PAPER8_EDGES = (
    (0, 1), (0, 4), (0, 2), (1, 2), (1, 3), (1, 5), (1, 7), (2, 3), (2, 6),
    (3, 6), (3, 7), (5, 6), (5, 7), (6, 7),
)


def graph_edges(name: str, m: int) -> Tuple[Edge, ...]:
    """The sorted edge list of a named base graph on m nodes (the paper's
    Fig. 1 graph, the one the cells run)."""
    if name != "paper8" or m != 8:
        raise KeyError(f"graph {name!r} on {m} nodes has no frozen copy")
    return tuple(sorted(PAPER8_EDGES))


def laplacian(m: int, edges) -> np.ndarray:
    A = np.zeros((m, m))
    for a, b in edges:
        A[a, b] = A[b, a] = 1.0
    return np.diag(A.sum(axis=1)) - A


def _canon(a: int, b: int) -> Edge:
    return (a, b) if a < b else (b, a)


class _Colouring:
    """Misra & Gries: a proper edge colouring with at most Delta + 1
    colours (fans, cd-path inversion, fan rotation)."""

    def __init__(self, m: int, edges):
        self.edges = edges
        self.nbrs = {v: tuple(sorted([b for a, b in edges if a == v]
                                     + [a for a, b in edges if b == v])) for v in range(m)}
        delta = max(len(n) for n in self.nbrs.values())
        self.ncolours = delta + 1
        self.colour: Dict[Edge, int] = {}
        self.incident: List[List[Optional[int]]] = [[None] * self.ncolours for _ in range(m)]

    def _set(self, e: Edge, c: int) -> None:
        old = self.colour.get(e)
        if old is not None:
            self.incident[e[0]][old] = self.incident[e[1]][old] = None
        self.colour[e] = c
        self.incident[e[0]][c], self.incident[e[1]][c] = e[1], e[0]

    def _unset(self, e: Edge) -> None:
        c = self.colour.pop(e, None)
        if c is not None:
            self.incident[e[0]][c] = self.incident[e[1]][c] = None

    def _free(self, v: int, c: int) -> bool:
        return self.incident[v][c] is None

    def _first_free(self, v: int) -> int:
        return next(c for c in range(self.ncolours) if self.incident[v][c] is None)

    def _fan(self, u: int, v: int) -> List[int]:
        fan, used = [v], {v}
        grown = True
        while grown:
            grown = False
            for w in self.nbrs[u]:
                if w in used:
                    continue
                cw = self.colour.get(_canon(u, w))
                if cw is not None and self._free(fan[-1], cw):
                    fan.append(w)
                    used.add(w)
                    grown = True
        return fan

    def _is_fan(self, u: int, fan: List[int]) -> bool:
        for i in range(len(fan) - 1):
            cw = self.colour.get(_canon(u, fan[i + 1]))
            if cw is None or not self._free(fan[i], cw):
                return False
        return True

    def _invert(self, u: int, c: int, d: int) -> None:
        path, seen, want, cur = [], [u], d, u
        while True:
            nxt = self.incident[cur][want]
            if nxt is None or nxt in seen:
                break
            path.append(_canon(cur, nxt))
            seen.append(nxt)
            cur, want = nxt, (c if want == d else d)
        for e in path:
            self._unset(e)
        want = c
        for e in path:
            self._set(e, want)
            want = c if want == d else d

    def run(self) -> Dict[Edge, int]:
        for u, v in self.edges:
            fan = self._fan(u, v)
            c, d = self._first_free(u), self._first_free(fan[-1])
            if c != d:
                self._invert(u, c, d)
            w_idx = None
            for i, w in enumerate(fan):
                if self._free(w, d) and self._is_fan(u, fan[:i + 1]):
                    w_idx = i
            if w_idx is None:
                w_idx = next(i for i, w in enumerate(fan) if self._free(w, d))
            sub = fan[:w_idx + 1]
            shifted = [self.colour[_canon(u, sub[i + 1])] for i in range(len(sub) - 1)]
            for w in sub:
                self._unset(_canon(u, w))
            for i, col in enumerate(shifted):
                self._set(_canon(u, sub[i]), col)
            self._set(_canon(u, sub[-1]), d)
        return dict(self.colour)


def matchings(m: int, edges) -> List[Tuple[Edge, ...]]:
    """The colour classes, densest first (ties by edge list)."""
    by_colour: Dict[int, List[Edge]] = {}
    for e, c in _Colouring(m, edges).run().items():
        by_colour.setdefault(c, []).append(e)
    out = [tuple(sorted(es)) for es in by_colour.values() if es]
    out.sort(key=lambda es: (-len(es), es))
    return out


def permutation(m: int, matching) -> np.ndarray:
    perm = np.arange(m)
    for a, b in matching:
        perm[a], perm[b] = b, a
    return perm


def _capped_simplex(p: np.ndarray, budget: float) -> np.ndarray:
    q = np.clip(p, 0.0, 1.0)
    if q.sum() <= budget + 1e-12:
        return q
    lo, hi = 0.0, float(np.max(p))
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if np.clip(p - mid, 0.0, 1.0).sum() > budget:
            lo = mid
        else:
            hi = mid
    return np.clip(p - hi, 0.0, 1.0)


def probabilities(laps: np.ndarray, cb: float, *, steps: int = 2000,
                  step_size: float = 0.5, tol: float = 1e-9, seed: int = 0) -> np.ndarray:
    """Paper eq. 4: maximise lambda_2(sum_j p_j L_j) over the capped simplex."""
    M = laps.shape[0]
    if cb >= 1.0 - 1e-12:
        return np.ones(M)
    rng = np.random.default_rng(seed)
    budget = cb * M
    p = np.full(M, cb)
    best_p, best = p.copy(), -np.inf
    for it in range(1, steps + 1):
        lam, vec = np.linalg.eigh(np.tensordot(p, laps, axes=1))
        if lam[1] > best:
            best, best_p = float(lam[1]), p.copy()
        v2 = vec[:, 1]
        grad = np.einsum("i,jik,k->j", v2, laps, v2)
        gnorm = np.linalg.norm(grad)
        if gnorm < tol:
            break
        p_new = p + step_size / np.sqrt(it) * grad / max(gnorm, 1e-12)
        if it % 50 == 0:
            p_new = p_new + rng.normal(scale=1e-4, size=M)
        p_new = _capped_simplex(p_new, budget)
        if np.linalg.norm(p_new - p) < tol:
            p = p_new
            break
        p = p_new
    return best_p


def _rho(alpha: float, L_bar: np.ndarray, L_tilde: np.ndarray) -> float:
    m = L_bar.shape[0]
    A = np.eye(m) - alpha * L_bar
    E = A @ A + 2.0 * alpha**2 * L_tilde - np.full((m, m), 1.0 / m)
    return float(np.max(np.abs(np.linalg.eigvalsh(E))))


def alpha(laps: np.ndarray, p: np.ndarray, *, tol: float = 1e-12, max_iter: int = 200) -> float:
    """Lemma 1: the alpha minimising rho, by golden section on its convex
    one-dimensional form."""
    L_bar = np.tensordot(p, laps, axes=1)
    L_tilde = np.tensordot(p * (1.0 - p), laps, axes=1)
    lam = np.linalg.eigvalsh(L_bar)
    zeta = float(np.max(np.abs(np.linalg.eigvalsh(L_tilde))))
    cands = [lv / (lv * lv + 2.0 * zeta) for lv in (float(lam[1]), float(lam[-1])) if lv > 0]
    a, b = 0.0, 2.0 * max(cands) if cands else 1.0
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = _rho(c, L_bar, L_tilde), _rho(d, L_bar, L_tilde)
    for _ in range(max_iter):
        if abs(b - a) < tol:
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = _rho(c, L_bar, L_tilde)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = _rho(d, L_bar, L_tilde)
    return float(0.5 * (a + b))


@dataclasses.dataclass(frozen=True)
class Plan:
    permutations: np.ndarray      # (M, m) involutions
    probabilities: np.ndarray     # (M,)
    alpha: float

    def schedule(self, steps: int, seed: int) -> np.ndarray:
        """The (steps, M) float32 activation bits, drawn a priori."""
        rng = np.random.default_rng(seed)
        return (rng.random((steps, len(self.probabilities)))
                < self.probabilities[None, :]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def plan(graph: str, m: int, cb: float, *, seed: int = 0) -> Plan:
    """MATCHA steps 1-3 for a named graph at communication budget cb
    (kept: a process that checks several runs plans once)."""
    edges = graph_edges(graph, m)
    ms = matchings(m, edges)
    laps = np.stack([laplacian(m, es) for es in ms])
    p = probabilities(laps, cb, seed=seed)
    return Plan(np.stack([permutation(m, es) for es in ms]), p, alpha(laps, p))
