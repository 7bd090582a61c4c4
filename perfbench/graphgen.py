"""The benchmark's dataset: a power-law graph with community structure,
made from a configuration's ``dataset`` block and a seed.

The generation arithmetic is the one the port's ``graph/generate.py``
uses for its ``*_sim`` datasets (clusters, Zipf popularity, lognormal
in-degrees, intra-cluster edges, Gaussian features around class
centres), kept here so that the inputs stay fixed while the program
changes. The result is plain numpy: an in-CSR (``indptr``, ``indices``:
the in-neighbours of each node), float32 features, int32 labels and
the train mask.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from perfbench.rng import rng_from


@dataclasses.dataclass
class GraphData:
    indptr: np.ndarray      # (n+1,) int64
    indices: np.ndarray     # (nnz,) int32 in-neighbour ids
    features: np.ndarray    # (n, d) float32
    labels: np.ndarray      # (n,) int32
    num_classes: int
    train_mask: np.ndarray  # (n,) bool

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def _zipf_weights(n: int, a: float, rng: np.random.Generator) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-a)
    rng.shuffle(w)
    return w / w.sum()


def make_graph(spec: Dict[str, Any], seed: int) -> GraphData:
    """``spec``: num_nodes, avg_degree, feat_dim, num_classes,
    num_clusters, zipf_a, p_intra, train_frac."""
    rng = rng_from(seed)
    n = int(spec["num_nodes"])
    n_clusters = int(spec["num_clusters"])
    n_classes = int(spec["num_classes"])
    d = int(spec["feat_dim"])

    clusters = rng.integers(0, n_clusters, size=n).astype(np.int32)
    popularity = _zipf_weights(n, float(spec["zipf_a"]), rng)
    deg = np.maximum(1, rng.lognormal(
        mean=np.log(float(spec["avg_degree"])) - 0.5, sigma=1.0,
        size=n)).astype(np.int64)
    deg = np.minimum(deg, n - 1)

    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    total = int(dst.shape[0])
    intra = rng.random(total) < float(spec["p_intra"])
    src = np.empty(total, dtype=np.int64)
    n_inter = int((~intra).sum())
    src[~intra] = rng.choice(n, size=n_inter, p=popularity)
    dst_cluster = clusters[dst]
    for c in range(n_clusters):
        members = np.flatnonzero(clusters == c)
        if members.size == 0:
            continue
        sel = np.flatnonzero(intra & (dst_cluster == c))
        if sel.size == 0:
            continue
        w = popularity[members]
        w = w / w.sum()
        src[sel] = members[rng.choice(members.size, size=sel.size, p=w)]
    self_loop = src == dst
    src[self_loop] = (dst[self_loop] + 1 + rng.integers(
        0, n - 2, size=int(self_loop.sum()))) % n

    labels = (clusters % n_classes).astype(np.int32)
    centers = rng.normal(0.0, 1.0, size=(n_classes, d))
    features = (centers[labels]
                + rng.normal(0.0, 2.0, size=(n, d))).astype(np.float32)
    train_mask = rng.random(n) < float(spec["train_frac"])

    # in-CSR: edges sorted stably by destination
    order = np.argsort(dst, kind="stable")
    indices = src[order].astype(np.int32)
    counts = np.bincount(dst[order], minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return GraphData(indptr=indptr, indices=indices, features=features,
                     labels=labels, num_classes=n_classes,
                     train_mask=train_mask)
