"""The partition, worked out again: a balanced edge-cut partition grown
breadth-first from the highest in-degree nodes, orphans to the smallest
parts, then one boundary sweep that moves a node to the majority part
of its in-neighbours where balance allows (the arithmetic of the port's
``greedy_partition``, its METIS stand-in). Its assignment is compared
with the program's node for node."""
from __future__ import annotations

from collections import deque

import numpy as np

from perfbench.rng import rng_from


def greedy_owner(indptr: np.ndarray, indices: np.ndarray, num_parts: int,
                 seed: int = 0) -> np.ndarray:
    """-> (n,) int32 owner of every node."""
    n = int(indptr.shape[0] - 1)
    cap = int(np.ceil(n / num_parts))
    owner = np.full(n, -1, dtype=np.int32)
    sizes = np.zeros(num_parts, dtype=np.int64)
    deg = np.diff(indptr)
    order = np.argsort(-deg)
    rng = rng_from(seed)

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
            budget = max(1, cap // 8)
            while frontiers[p] and sizes[p] < cap and budget > 0:
                v = frontiers[p].popleft()
                for u in indices[indptr[v]:indptr[v + 1]]:
                    u = int(u)
                    if owner[u] == -1 and sizes[p] < cap:
                        owner[u] = p
                        sizes[p] += 1
                        frontiers[p].append(u)
                        budget -= 1
            if frontiers[p] and sizes[p] < cap:
                nxt.append(p)
        active = nxt

    orphans = np.flatnonzero(owner == -1)
    if orphans.size:
        rng.shuffle(orphans)
        for v in orphans:
            p = int(np.argmin(sizes))
            owner[v] = p
            sizes[p] += 1

    for v in rng.permutation(n)[: n // 4]:
        nb = indices[indptr[v]:indptr[v + 1]]
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
    return owner
