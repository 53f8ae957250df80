"""Base communication topologies.

Every graph is represented as a ``Graph`` dataclass: an immutable edge
list over vertices ``0..m-1``. Includes the paper's experimental
topologies (Fig. 1 8-node graph, 16-node random geometric graphs of
varying density, Erdos-Renyi) plus standard families (ring, torus,
hypercube, expander-ish) used in the wider decentralized-SGD literature.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import FrozenSet, Tuple

import numpy as np

Edge = Tuple[int, int]


def _canon(e: Edge) -> Edge:
    a, b = e
    if a == b:
        raise ValueError(f"self-loop {e} not allowed (simple graph)")
    return (a, b) if a < b else (b, a)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Simple undirected graph on vertices ``0..m-1``."""

    m: int
    edges: Tuple[Edge, ...]

    def __post_init__(self):
        canon = tuple(sorted({_canon(e) for e in self.edges}))
        if len(canon) != len(self.edges):
            object.__setattr__(self, "edges", canon)
        else:
            object.__setattr__(self, "edges", canon)
        for a, b in self.edges:
            if not (0 <= a < self.m and 0 <= b < self.m):
                raise ValueError(f"edge ({a},{b}) out of range for m={self.m}")

    # -- linear-algebra views ------------------------------------------------
    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.m, self.m), dtype=np.float64)
        for a, b in self.edges:
            A[a, b] = A[b, a] = 1.0
        return A

    def degrees(self) -> np.ndarray:
        return self.adjacency().sum(axis=1)

    def max_degree(self) -> int:
        return int(self.degrees().max()) if self.edges else 0

    def laplacian(self) -> np.ndarray:
        A = self.adjacency()
        return np.diag(A.sum(axis=1)) - A

    def neighbors(self, v: int) -> Tuple[int, ...]:
        out = []
        for a, b in self.edges:
            if a == v:
                out.append(b)
            elif b == v:
                out.append(a)
        return tuple(sorted(out))

    # -- properties ----------------------------------------------------------
    def is_connected(self) -> bool:
        if self.m == 1:
            return True
        if not self.edges:
            return False
        seen = {0}
        frontier = [0]
        adj = {v: set() for v in range(self.m)}
        for a, b in self.edges:
            adj[a].add(b)
            adj[b].add(a)
        while frontier:
            v = frontier.pop()
            for u in adj[v]:
                if u not in seen:
                    seen.add(u)
                    frontier.append(u)
        return len(seen) == self.m

    def algebraic_connectivity(self) -> float:
        lam = np.linalg.eigvalsh(self.laplacian())
        return float(lam[1])

    def edge_set(self) -> FrozenSet[Edge]:
        return frozenset(self.edges)


# ---------------------------------------------------------------------------
# Paper topologies
# ---------------------------------------------------------------------------

def paper_figure1_graph() -> Graph:
    """8-node base graph consistent with Fig. 1 of the paper.

    Constraints from the figure/caption: 8 nodes; max degree 5 (node 1);
    node 4 has degree 1 and hangs off node 0 via the connectivity-critical
    edge (0, 4); decomposes into 6 matchings (Delta or Delta+1).
    """
    edges = [
        (0, 1), (0, 4), (0, 2),
        (1, 2), (1, 3), (1, 5), (1, 7),
        (2, 3), (2, 6),
        (3, 6), (3, 7),
        (5, 6), (5, 7),
        (6, 7),
    ]
    g = Graph(8, tuple(edges))
    assert g.max_degree() == 5 and g.is_connected()
    assert int(g.degrees()[4]) == 1
    return g


def random_geometric_graph(m: int, radius: float, seed: int) -> Graph:
    """Random geometric graph on the unit square (paper Figs. 5/9).

    Re-draws until connected (as done in practice for RGG benchmarks).
    """
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        pts = rng.random((m, 2))
        edges = [
            (i, j)
            for i, j in itertools.combinations(range(m), 2)
            if np.hypot(*(pts[i] - pts[j])) <= radius
        ]
        g = Graph(m, tuple(edges))
        if g.is_connected():
            return g
    raise RuntimeError("could not sample a connected geometric graph")


def erdos_renyi_graph(m: int, p: float, seed: int) -> Graph:
    """Erdos-Renyi G(m, p) (paper Fig. 3c), re-drawn until connected."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        edges = [
            (i, j)
            for i, j in itertools.combinations(range(m), 2)
            if rng.random() < p
        ]
        g = Graph(m, tuple(edges))
        if g.is_connected():
            return g
    raise RuntimeError("could not sample a connected ER graph")


# ---------------------------------------------------------------------------
# Standard families
# ---------------------------------------------------------------------------

def ring_graph(m: int) -> Graph:
    if m < 3:
        raise ValueError("ring needs m >= 3")
    return Graph(m, tuple((i, (i + 1) % m) for i in range(m)))


def torus_graph(rows: int, cols: int) -> Graph:
    m = rows * cols
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            edges.append((v, r * cols + (c + 1) % cols))
            edges.append((v, ((r + 1) % rows) * cols + c))
    return Graph(m, tuple(edges))


def hypercube_graph(dim: int) -> Graph:
    m = 1 << dim
    edges = [(v, v ^ (1 << d)) for v in range(m) for d in range(dim) if v < v ^ (1 << d)]
    return Graph(m, tuple(edges))


def complete_graph(m: int) -> Graph:
    return Graph(m, tuple(itertools.combinations(range(m), 2)))


def star_graph(m: int) -> Graph:
    return Graph(m, tuple((0, i) for i in range(1, m)))


def named_graph(name: str, m: int, seed: int = 0) -> Graph:
    """Registry used by configs / CLI (``--graph <name>``)."""
    if name == "paper8":
        return paper_figure1_graph()
    if name == "ring":
        return ring_graph(m)
    if name == "torus":
        rows = int(np.sqrt(m))
        while m % rows:
            rows -= 1
        return torus_graph(rows, m // rows)
    if name == "hypercube":
        dim = int(np.log2(m))
        if 1 << dim != m:
            raise ValueError("hypercube needs power-of-two m")
        return hypercube_graph(dim)
    if name == "complete":
        return complete_graph(m)
    if name == "star":
        return star_graph(m)
    if name == "geometric-sparse":   # paper Fig 9(a): max degree ~5-6
        return random_geometric_graph(m, radius=0.42, seed=seed)
    if name == "geometric-dense":    # paper Fig 9(b): max degree ~10
        return random_geometric_graph(m, radius=0.6, seed=seed)
    if name == "erdos-renyi":        # paper Fig 3(c): max degree ~8
        return erdos_renyi_graph(m, p=0.35, seed=seed)
    raise KeyError(f"unknown graph family {name!r}")
