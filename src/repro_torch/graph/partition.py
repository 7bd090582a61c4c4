"""Graph partitioning: random baseline + greedy balanced edge-cut.

The paper partitions with METIS (balanced edge-cut) and compares against a
random partitioner. METIS itself is unavailable offline; ``greedy_partition``
is a multilevel-flavoured stand-in: BFS-grown regions seeded at high-degree
nodes with a balance constraint, followed by a boundary-refinement pass
(Kernighan-Lin flavoured, single sweep). Its cut quality is below real
METIS, which *increases* the remote-node fraction every method sees --
conservative for RapidGNN's relative claims (see DESIGN.md §9).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.graph.graph import Graph
from repro_torch.graph.sampler import rng_from


@dataclasses.dataclass
class PartitionedGraph:
    graph: Graph
    num_parts: int
    owner: np.ndarray            # (n,) int32: worker owning node v
    local_nodes: List[np.ndarray]  # per worker, global ids it owns

    @property
    def part_sizes(self) -> np.ndarray:
        return np.array([ln.shape[0] for ln in self.local_nodes])

    def edge_cut_fraction(self) -> float:
        g = self.graph
        dst = np.repeat(np.arange(g.num_nodes), g.in_degree())
        cut = self.owner[g.indices] != self.owner[dst]
        return float(cut.mean()) if cut.size else 0.0

    def remote_fraction(self, nodes: np.ndarray, worker: int) -> float:
        return float((self.owner[nodes] != worker).mean()) if nodes.size else 0.0


def _finalize(graph: Graph, owner: np.ndarray, num_parts: int) -> PartitionedGraph:
    local = [np.flatnonzero(owner == p).astype(np.int64)
             for p in range(num_parts)]
    return PartitionedGraph(graph=graph, num_parts=num_parts,
                            owner=owner.astype(np.int32), local_nodes=local)


def random_partition(graph: Graph, num_parts: int, seed: int = 0) -> PartitionedGraph:
    rng = rng_from(seed)        # RNG-CONTRACT: keyed Philox stream
    n = graph.num_nodes
    # balanced random: shuffle then chunk
    perm = rng.permutation(n)
    owner = np.empty(n, dtype=np.int32)
    for p, chunk in enumerate(np.array_split(perm, num_parts)):
        owner[chunk] = p
    return _finalize(graph, owner, num_parts)


def greedy_partition(graph: Graph, num_parts: int, seed: int = 0,
                     refine_sweeps: int = 1) -> PartitionedGraph:
    """BFS-grown balanced edge-cut partitioning (METIS stand-in)."""
    n = graph.num_nodes
    cap = int(np.ceil(n / num_parts))
    owner = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)

    # undirected adjacency for growth
    deg = graph.in_degree()
    order = np.argsort(-deg)            # seeds at high-degree nodes
    rng = rng_from(seed)        # RNG-CONTRACT: keyed Philox stream

    from collections import deque
    frontiers = [deque() for _ in range(num_parts)]
    si = 0
    for p in range(num_parts):
        while si < n and owner[order[si]] != -1:
            si += 1
        if si < n:
            v = int(order[si])
            owner[v] = p
            sizes[p] += 1
            frontiers[p].append(v)

    active = list(range(num_parts))
    while active:
        nxt = []
        for p in active:
            grew = False
            budget = max(1, cap // 8)
            while frontiers[p] and sizes[p] < cap and budget > 0:
                v = frontiers[p].popleft()
                for u in graph.neighbors(v):
                    u = int(u)
                    if owner[u] == -1 and sizes[p] < cap:
                        owner[u] = p
                        sizes[p] += 1
                        frontiers[p].append(u)
                        grew = True
                        budget -= 1
            if frontiers[p] and sizes[p] < cap:
                nxt.append(p)
            _ = grew
        active = nxt

    # orphans (disconnected remainder): fill smallest parts
    orphans = np.flatnonzero(owner == -1)
    if orphans.size:
        rng.shuffle(orphans)
        for v in orphans:
            p = int(np.argmin(sizes))
            owner[v] = p
            sizes[p] += 1

    # single boundary refinement sweep: move a node to the majority
    # partition of its neighbors if balance allows
    dst_of_edge = np.repeat(np.arange(n), graph.in_degree())
    for _ in range(refine_sweeps):
        moved = 0
        for v in rng.permutation(n)[: n // 4]:
            nb = graph.neighbors(int(v))
            if nb.size == 0:
                continue
            counts = np.bincount(owner[nb], minlength=num_parts)
            best = int(np.argmax(counts))
            cur = int(owner[v])
            if best != cur and counts[best] > counts[cur] and \
                    sizes[best] < cap and sizes[cur] > cap // 2:
                owner[v] = best
                sizes[best] += 1
                sizes[cur] -= 1
                moved += 1
        if moved == 0:
            break
    _ = dst_of_edge
    return _finalize(graph, owner, num_parts)


def partition_graph(graph: Graph, num_parts: int, method: str = "greedy",
                    seed: int = 0) -> PartitionedGraph:
    if method == "random":
        return random_partition(graph, num_parts, seed)
    if method in ("greedy", "metis"):
        return greedy_partition(graph, num_parts, seed)
    raise ValueError(f"unknown partition method {method!r}")
