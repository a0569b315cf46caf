"""Cayley-graph symmetric placements (paper Appendix B; the port's copy
of ``repro.core.graphs``).

For the d=2 case the placement hypergraph is a conventional graph: vertices
are devices, each expert is an edge between the two devices hosting its two
replicas.  Appendix B constructs near-optimal symmetric placements from Cayley
graphs of abelian groups for power-of-two device/expert counts.

These constructions are exposed both as raw edge lists (for the density tests
replicating Appendix B.2) and as 2-row ``Placement`` tables usable by the
scheduler when a MicroEP group merges exactly two EP groups (d=2).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .placement import Placement

__all__ = [
    "cayley_cycle",
    "cayley_torus",
    "cayley_bipartite",
    "cayley_complete_plus",
    "cayley_graph_auto",
    "edges_to_two_row_placement",
    "max_density_subgraph_exact",
]

Edge = Tuple[int, int]


def cayley_cycle(n: int) -> List[Edge]:
    """Example 1: group Z_n, generators {1,-1} -> a cycle (n vertices, n edges)."""
    return [(i, (i + 1) % n) for i in range(n)]


def cayley_torus(side: int) -> List[Edge]:
    """Example 2: group Z_side x Z_side, generators {(0,±1),(±1,0)} ->
    toroidal grid (side^2 vertices, 2*side^2 edges)."""
    edges = []
    for x in range(side):
        for y in range(side):
            v = x * side + y
            edges.append((v, x * side + (y + 1) % side))
            edges.append((v, ((x + 1) % side) * side + y))
    return edges


def cayley_bipartite(n: int = 8) -> List[Edge]:
    """Example 3: group Z_2 x Z_4, generators {(0,±1),(1,±1)} — isomorphic to
    K_{4,4} for n=8 (8 vertices, 16 edges).  Generalized to Z_2 x Z_{n/2}."""
    half = n // 2
    edges = []
    for a in range(2):
        for b in range(half):
            v = a * half + b
            for (da, db) in ((0, 1), (1, 1)):
                w = ((a + da) % 2) * half + (b + db) % half
                edges.append((v, w))
                w2 = ((a + da) % 2) * half + (b - db) % half
                edges.append((v, w2))
    # Each undirected edge generated twice (s and s^-1); dedupe keeping
    # multiplicity parity of the construction (degree 4 -> 2n edges total).
    seen = {}
    out = []
    for (u, v) in edges:
        key = (min(u, v), max(u, v))
        seen[key] = seen.get(key, 0) + 1
    for key, cnt in seen.items():
        out.extend([key] * (cnt // 2))
    return out


def cayley_complete_plus(n: int, num_edges: int) -> List[Edge]:
    """Example 4: complete graph K_n plus extra perfect-matching edges until
    ``num_edges`` edges (requires num_edges >= n(n-1)/2)."""
    edges = [(i, j) for i in range(n) for j in range(i + 1, n)]
    extra = num_edges - len(edges)
    if extra < 0:
        raise ValueError("num_edges smaller than complete graph")
    i = 0
    while extra > 0:
        for a in range(0, n, 2):
            if extra == 0:
                break
            edges.append(((a + i) % n, (a + 1 + i) % n))
            extra -= 1
        i += 1
    return edges


def cayley_graph_auto(num_vertices: int, num_edges: int) -> List[Edge]:
    """Pick an Appendix-B construction for (2^p vertices, 2^{p+q-1} edges)."""
    n, m = num_vertices, num_edges
    if m == n:
        return cayley_cycle(n)
    if m >= n * (n - 1) // 2:
        return cayley_complete_plus(n, m)
    side = int(round(np.sqrt(n)))
    if side * side == n and m == 2 * n:
        return cayley_torus(side)
    if m == 2 * n:
        return cayley_bipartite(n)
    # fallback: circulant graph with generators 1..m//n (+ leftovers)
    edges: List[Edge] = []
    step = 1
    while len(edges) + n <= m:
        edges.extend((i, (i + step) % n) for i in range(n))
        step += 1
    for i in range(m - len(edges)):
        edges.append((i % n, (i + step) % n))
    return edges


def edges_to_two_row_placement(edges: Sequence[Edge], cols: int) -> Placement:
    """Convert a d=2 graph over ``2*cols`` vertices into a 2-row placement.

    Vertex v < cols maps to device (row 0, col v); vertex v >= cols maps to
    (row 1, col v-cols).  Edge i = expert i's EDP group.  For a graph where
    every vertex has the same degree k, the result is a dense [2, cols, k]
    table.  Edges joining two vertices of the same row are not representable
    on a 2-row mesh placement (a device pair must straddle rows for the
    all_to_all grouping); such graphs raise ValueError.
    """
    num_vertices = 2 * cols
    k = (2 * len(edges)) // num_vertices
    table = np.full((2, cols, k), -1, dtype=np.int32)
    fill = np.zeros((2, cols), dtype=np.int64)
    for e, (u, v) in enumerate(edges):
        for vert in (u, v):
            r, c = divmod(vert, cols)
            if fill[r, c] >= k:
                raise ValueError("graph is not row-regular enough for a mesh placement")
            table[r, c, fill[r, c]] = e
            fill[r, c] += 1
    if (table < 0).any():
        raise ValueError("edge count does not fill all replica slots")
    return Placement(table, len(edges))


def max_density_subgraph_exact(
    num_vertices: int, edges: Sequence[Edge], weights: Sequence[float]
) -> float:
    """Eq. 3 for a d=2 graph: max over vertex subsets of induced weight/|S|."""
    assert num_vertices <= 20
    w = np.asarray(weights, dtype=np.float64)
    masks = np.array([(1 << u) | (1 << v) for (u, v) in edges], dtype=np.int64)
    best = 0.0
    for sub in range(1, 1 << num_vertices):
        inside = (masks & ~sub) == 0
        tot = w[inside].sum()
        if tot > 0:
            best = max(best, tot / bin(sub).count("1"))
    return float(best)
