"""Matching decomposition via Misra & Gries edge coloring (Step 1 of MATCHA).

A proper edge coloring partitions the edge set into color classes; each
class is a matching (vertex-disjoint edges). Misra & Gries (1992,
constructive proof of Vizing's theorem) colors any simple graph with at
most ``Delta + 1`` colors, hence MATCHA's guarantee
``M in {Delta, Delta+1}``.

Implemented from scratch (no external solver): fans, cd-paths with
inversion, and fan rotation, exactly as in the constructive proof.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.graphs import Edge, Graph, _canon


class _EdgeColoring:
    def __init__(self, graph: Graph):
        self.g = graph
        self.delta = graph.max_degree()
        self.ncolors = self.delta + 1
        self.color: Dict[Edge, int] = {}
        # incident[v][c] = neighbor joined to v by an edge of color c (or None)
        self.incident: List[List[Optional[int]]] = [
            [None] * self.ncolors for _ in range(graph.m)
        ]

    # -- bookkeeping ---------------------------------------------------------
    def _set(self, e: Edge, c: int) -> None:
        a, b = e
        old = self.color.get(e)
        if old is not None:
            self.incident[a][old] = None
            self.incident[b][old] = None
        self.color[e] = c
        self.incident[a][c] = b
        self.incident[b][c] = a

    def _unset(self, e: Edge) -> None:
        a, b = e
        c = self.color.pop(e, None)
        if c is not None:
            self.incident[a][c] = None
            self.incident[b][c] = None

    def _is_free(self, v: int, c: int) -> bool:
        return self.incident[v][c] is None

    def _free_color(self, v: int) -> int:
        for c in range(self.ncolors):
            if self.incident[v][c] is None:
                return c
        raise AssertionError("vertex has no free color among Delta+1 colors")

    # -- fans ----------------------------------------------------------------
    def _maximal_fan(self, u: int, v: int) -> List[int]:
        """Fan of u: F[0]=v; c(u, F[i+1]) must be free on F[i]."""
        fan = [v]
        used = {v}
        nbrs = [w for w in self.g.neighbors(u) if w not in used]
        extended = True
        while extended:
            extended = False
            for w in nbrs:
                if w in used:
                    continue
                cw = self.color.get(_canon((u, w)))
                if cw is not None and self._is_free(fan[-1], cw):
                    fan.append(w)
                    used.add(w)
                    extended = True
        return fan

    def _rotate_fan(self, u: int, fan: List[int]) -> None:
        """Shift colors along the fan: c(u,F[i]) <- c(u,F[i+1]); last uncolored.

        All fan edges are uncolored before reassignment: during a naive
        in-place shift two edges at ``u`` transiently share a color and
        the shared ``incident`` slot would be clobbered by the final
        unset. The complete rotation is proper (fan property), so
        unset-all-then-set-all is safe.
        """
        shifted = [
            self.color[_canon((u, fan[i + 1]))] for i in range(len(fan) - 1)
        ]
        for w in fan:
            self._unset(_canon((u, w)))
        for i, c in enumerate(shifted):
            self._set(_canon((u, fan[i])), c)

    # -- cd paths ------------------------------------------------------------
    def _invert_cd_path(self, u: int, c: int, d: int) -> None:
        """Invert the maximal path from u whose edges alternate colors d, c.

        (Path starts with color d since c is free on u.)
        """
        path_vertices = [u]
        path_edges: List[Edge] = []
        want = d
        cur = u
        while True:
            nxt = self.incident[cur][want]
            if nxt is None or nxt in path_vertices:
                break
            path_edges.append(_canon((cur, nxt)))
            path_vertices.append(nxt)
            cur = nxt
            want = c if want == d else d
        # Swap colors along the path.
        for e in path_edges:
            self._unset(e)
        want = c  # first edge had d, becomes c
        for e in path_edges:
            self._set(e, want)
            want = c if want == d else d

    # -- main loop -----------------------------------------------------------
    def run(self) -> Dict[Edge, int]:
        for e in self.g.edges:
            u, v = e
            fan = self._maximal_fan(u, v)
            c = self._free_color(u)
            d = self._free_color(fan[-1])
            if c != d:
                self._invert_cd_path(u, c, d)
            # After inversion the fan may no longer be valid past some w
            # with d free on w; find first such prefix.
            w_idx = None
            for i, w in enumerate(fan):
                if self._is_free(w, d) and self._prefix_is_fan(u, fan[: i + 1]):
                    w_idx = i
            if w_idx is None:
                # fall back: d became free on fan[0] after inversion
                for i, w in enumerate(fan):
                    if self._is_free(w, d):
                        w_idx = i
                        break
            assert w_idx is not None, "Misra-Gries invariant violated"
            sub = fan[: w_idx + 1]
            self._rotate_fan(u, sub)
            self._set(_canon((u, sub[-1])), d)
        return dict(self.color)

    def _prefix_is_fan(self, u: int, fan: List[int]) -> bool:
        for i in range(len(fan) - 1):
            cw = self.color.get(_canon((u, fan[i + 1])))
            if cw is None or not self._is_free(fan[i], cw):
                return False
        return True


def misra_gries_coloring(graph: Graph) -> Dict[Edge, int]:
    """Proper edge coloring with at most Delta+1 colors."""
    coloring = _EdgeColoring(graph).run()
    _validate(graph, coloring)
    return coloring


def _validate(graph: Graph, coloring: Dict[Edge, int]) -> None:
    if set(coloring) != set(graph.edges):
        raise AssertionError("coloring does not cover the edge set exactly")
    ncolors = max(coloring.values(), default=-1) + 1
    if ncolors > graph.max_degree() + 1:
        raise AssertionError(
            f"used {ncolors} colors > Delta+1 = {graph.max_degree() + 1}"
        )
    seen: Dict[Tuple[int, int], Edge] = {}
    for (a, b), c in coloring.items():
        for v in (a, b):
            key = (v, c)
            if key in seen:
                raise AssertionError(
                    f"color {c} repeated at vertex {v}: {seen[key]} and {(a, b)}"
                )
            seen[key] = (a, b)


def matching_decomposition(graph: Graph) -> List[Graph]:
    """MATCHA Step 1: G = union of M disjoint matchings, M <= Delta+1.

    Returns matchings sorted by descending edge count (denser matchings
    first, a stable convention used by the schedule and tests).
    """
    coloring = misra_gries_coloring(graph)
    by_color: Dict[int, List[Edge]] = {}
    for e, c in coloring.items():
        by_color.setdefault(c, []).append(e)
    matchings = [
        Graph(graph.m, tuple(sorted(edges))) for edges in by_color.values() if edges
    ]
    matchings.sort(key=lambda sg: (-len(sg.edges), sg.edges))
    return matchings


def validate_permutations(permutations, num_nodes: int) -> np.ndarray:
    """Check every row of a ``(M, m)`` permutation stack is a matching.

    A matching's node permutation must be an in-range involution —
    partners swapped, everyone else fixed, so each node has gossip
    degree <= 1.  ``plan_matcha``/``plan_vanilla``/``plan_periodic``
    call this at plan time (via ``MatchaPlan``) instead of trusting the
    sampler; the static analyzer re-checks the same property on the
    ppermute pairs it finds in traced jaxprs.

    Raises ``ValueError`` naming the offending matching id.  Returns the
    validated stack as an int array.
    """
    perms = np.asarray(permutations)
    if perms.ndim != 2 or perms.shape[1] != num_nodes:
        raise ValueError(
            f"permutations must be (M, {num_nodes}), got {perms.shape}"
        )
    if not np.issubdtype(perms.dtype, np.integer):
        raise ValueError(
            f"permutations must be integer node indices, got {perms.dtype}"
        )
    idx = np.arange(num_nodes)
    for j, perm in enumerate(perms):
        if perm.min(initial=0) < 0 or perm.max(initial=-1) >= num_nodes:
            raise ValueError(
                f"matching {j}: permutation targets out of range "
                f"[0, {num_nodes}): {perm.tolist()}"
            )
        counts = np.bincount(perm, minlength=num_nodes)
        if (counts > 1).any():
            dup = int(np.argmax(counts > 1))
            raise ValueError(
                f"matching {j}: node {dup} is the partner of "
                f"{int(counts[dup])} nodes — a matching has degree <= 1"
            )
        if not (perm[perm] == idx).all():
            bad = int(np.argmax(perm[perm] != idx))
            raise ValueError(
                f"matching {j}: permutation is not an involution — node "
                f"{bad} maps to {int(perm[bad])} but "
                f"{int(perm[bad])} maps to {int(perm[perm[bad]])}"
            )
    return perms


def matching_permutation(matching: Graph) -> np.ndarray:
    """A matching as a node permutation: partners swapped, others fixed.

    This is the object `lax.ppermute` consumes on the TPU side — a
    matching is exactly an involutive permutation with disjoint support.
    """
    perm = np.arange(matching.m)
    for a, b in matching.edges:
        perm[a], perm[b] = b, a
    return perm
