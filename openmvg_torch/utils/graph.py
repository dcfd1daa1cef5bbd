"""Host-side view-graph algorithms (counterpart: openmvg_tpu/utils/graph.py).

Pair generation for the pairs stage (Pair_Builder.hpp), and for the
global engine: connected components (graph_builder.hpp), the largest
bi-edge-connected subgraph (connectedComponent.hpp:64
CleanGraph_KeepLargestBiEdge_Nodes) and triplet listing
(triplet_finder.hpp:31).  View graphs have at most a few thousand nodes:
Python adjacency loops where vectorisation is awkward (bridges), scipy
elsewhere.  The outputs, triplet order included, are the reference's: the
global engine's greedy edge coverage visits triplets in this order.
"""

from collections import defaultdict
from typing import Dict, Iterable, List, Set, Tuple

import numpy as np
from scipy import sparse
from scipy.sparse import csgraph


def contiguous_pairs(n_views: int, overlap: int) -> List[Tuple[int, int]]:
    """Windowed pair list (Pair_Builder.hpp:37 contiguousWithOverlap)."""
    return [(i, j) for i in range(n_views)
            for j in range(i + 1, min(i + overlap + 1, n_views))]


def exhaustive_pairs(n_views: int) -> List[Tuple[int, int]]:
    """All pairs (Pair_Builder.hpp:25 exhaustivePairs)."""
    return [(i, j) for i in range(n_views) for j in range(i + 1, n_views)]


def pairs_to_edges(pairs: Iterable[Tuple[int, int]]) -> np.ndarray:
    """Sorted unique (min, max) edges, (E, 2) int64."""
    e = np.asarray(sorted(set((min(i, j), max(i, j)) for i, j in pairs)), np.int64)
    return e.reshape(-1, 2)


def connected_components(pairs) -> List[Set[int]]:
    """Connected components of the pair graph, largest first."""
    e = pairs_to_edges(pairs)
    if len(e) == 0:
        return []
    nodes, inv = np.unique(e.ravel(), return_inverse=True)
    ii = inv.reshape(-1, 2)
    g = sparse.coo_matrix((np.ones(len(ii)), (ii[:, 0], ii[:, 1])), shape=(len(nodes),) * 2)
    _, labels = csgraph.connected_components(g, directed=False)
    comps = defaultdict(set)
    for node, lab in zip(nodes, labels):
        comps[lab].add(int(node))
    return sorted(comps.values(), key=len, reverse=True)


def _bridges(adj: Dict[int, Set[int]]) -> Set[Tuple[int, int]]:
    """Tarjan bridge finding (iterative DFS)."""
    disc, low = {}, {}
    bridges = set()
    timer = 0
    for root in adj:
        if root in disc:
            continue
        stack = [(root, None, iter(adj[root]))]
        disc[root] = low[root] = timer
        timer += 1
        while stack:
            u, parent, it = stack[-1]
            advanced = False
            for v in it:
                if v == parent:
                    continue
                if v in disc:
                    low[u] = min(low[u], disc[v])
                else:
                    disc[v] = low[v] = timer
                    timer += 1
                    stack.append((v, u, iter(adj[v])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                if stack:
                    p = stack[-1][0]
                    low[p] = min(low[p], low[u])
                    if low[u] > disc[p]:
                        bridges.add((min(p, u), max(p, u)))
    return bridges


def _adjacency(e):
    adj = defaultdict(set)
    for i, j in e:
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    return adj


def largest_biedge_connected_component(pairs) -> Set[int]:
    """Nodes of the largest 2-edge-connected component: bridges removed,
    largest connected component kept."""
    e = pairs_to_edges(pairs)
    if len(e) == 0:
        return set()
    bridges = _bridges(_adjacency(e))
    kept = [tuple(p) for p in e if (int(p[0]), int(p[1])) not in bridges]
    comps = connected_components(kept)
    return comps[0] if comps else set()


def list_triplets(pairs) -> List[Tuple[int, int, int]]:
    """All (i < j < k) with all three edges present (TripletListing), in
    edge order and, per edge, in the order of the set of common
    neighbours, as the reference lists them."""
    e = pairs_to_edges(pairs)
    adj = _adjacency(e)
    triplets = []
    for i, j in e:
        i, j = int(i), int(j)
        for k in adj[i] & adj[j]:
            if k > j:
                triplets.append((i, j, k))
    return triplets
