"""Synthetic benchmark graphs with paper-matched statistics.

The paper evaluates on Reddit (233 k nodes / 114.8 M edges / d=602 / 50
classes), OGBN-Products (2.45 M / 123.7 M / d=100 / 47) and OGBN-Papers100M
(111 M / 1.62 B / d=128 / 172). Those datasets are not redistributable
offline, so we generate scaled-down graphs that preserve the properties
RapidGNN's claims depend on:

  * long-tail (power-law) access popularity -> hub "celebrity" nodes
    (paper Fig. 3: ~45 % of remote nodes touched once, max freq ~66),
  * community structure (so an edge-cut partitioner has locality to find,
    and a random partitioner does not),
  * exact feature dimensionality / class counts (these set the bytes that
    move on the wire),
  * a learnable node-classification task (labels correlated with the
    community + features) for the convergence-parity experiment.

Generation model: nodes are assigned to clusters; each node draws an
in-degree from a heavy-tailed lognormal; in-neighbors are sampled with
probability ``p_intra`` from the node's own cluster (else globally), in
both cases weighted by a Zipf popularity over nodes. Popularity-weighted
endpoint choice is what produces hub nodes with huge *out*-fanin, i.e.
nodes whose features every worker keeps re-fetching -- the access pattern
in the paper's Fig. 3.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.graph import Graph
from repro_torch.graph.sampler import rng_from


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_nodes: int
    avg_degree: float
    feat_dim: int
    num_classes: int
    num_clusters: int
    zipf_a: float            # popularity exponent (p ~ rank^-a)
    p_intra: float           # probability an edge stays inside the cluster
    train_frac: float
    # paper-scale statistics, kept for reporting / extrapolation
    paper_nodes: int = 0
    paper_edges: int = 0


DATASETS = {
    # name:                 nodes   deg  d    C   clus  a     intra train
    "reddit_sim": DatasetSpec("reddit_sim", 60_000, 90.0, 602, 50, 50, 1.05,
                              0.75, 0.66, paper_nodes=232_965,
                              paper_edges=114_800_000),
    "ogbn_products_sim": DatasetSpec("ogbn_products_sim", 192_000, 50.0, 100,
                                     47, 96, 0.95, 0.80, 0.40,
                                     paper_nodes=2_449_029,
                                     paper_edges=123_700_000),
    "ogbn_papers_sim": DatasetSpec("ogbn_papers_sim", 256_000, 15.0, 128, 172,
                                   128, 0.90, 0.85, 0.08,
                                   paper_nodes=111_059_956,
                                   paper_edges=1_620_000_000),
    # tiny variant for unit tests
    "tiny": DatasetSpec("tiny", 1_000, 8.0, 32, 8, 8, 1.0, 0.7, 0.5),
}


def _zipf_weights(n: int, a: float, rng: np.random.Generator) -> np.ndarray:
    """Popularity ~ rank^-a, randomly permuted over node ids."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-a)
    rng.shuffle(w)
    return w / w.sum()


def make_powerlaw_graph(spec: DatasetSpec, seed: int = 0) -> Graph:
    rng = rng_from(seed)        # RNG-CONTRACT: keyed Philox stream
    n = spec.num_nodes

    clusters = rng.integers(0, spec.num_clusters, size=n).astype(np.int32)
    popularity = _zipf_weights(n, spec.zipf_a, rng)

    # heavy-tailed in-degrees around avg_degree
    deg = np.maximum(
        1, rng.lognormal(mean=np.log(spec.avg_degree) - 0.5, sigma=1.0,
                         size=n)).astype(np.int64)
    deg = np.minimum(deg, n - 1)

    dst = np.repeat(np.arange(n, dtype=np.int64), deg)
    total = int(dst.shape[0])
    intra = rng.random(total) < spec.p_intra

    src = np.empty(total, dtype=np.int64)
    # global (inter-cluster) endpoints: one big popularity-weighted draw
    n_inter = int((~intra).sum())
    src[~intra] = rng.choice(n, size=n_inter, p=popularity)

    # intra-cluster endpoints: draw per cluster (vectorized inside cluster)
    dst_cluster = clusters[dst]
    for c in range(spec.num_clusters):
        members = np.flatnonzero(clusters == c)
        if members.size == 0:
            continue
        sel = np.flatnonzero(intra & (dst_cluster == c))
        if sel.size == 0:
            continue
        w = popularity[members]
        w = w / w.sum()
        src[sel] = members[rng.choice(members.size, size=sel.size, p=w)]

    # no self loops (redirect to a random neighbor)
    self_loop = src == dst
    src[self_loop] = (dst[self_loop] + 1 + rng.integers(
        0, n - 2, size=int(self_loop.sum()))) % n

    labels = (clusters % spec.num_classes).astype(np.int32)
    centers = rng.normal(0.0, 1.0, size=(spec.num_classes, spec.feat_dim))
    features = (centers[labels] +
                rng.normal(0.0, 2.0, size=(n, spec.feat_dim))
                ).astype(np.float32)

    train_mask = rng.random(n) < spec.train_frac

    g = Graph.from_edges(src=src.astype(np.int64), dst=dst, num_nodes=n,
                         features=features, labels=labels,
                         num_classes=spec.num_classes)
    g.train_mask = train_mask
    g.validate()
    return g


_CACHE: dict = {}


def load_dataset(name: str, seed: int = 0) -> Graph:
    key = (name, seed)
    if key not in _CACHE:
        _CACHE[key] = make_powerlaw_graph(DATASETS[name], seed=seed)
    return _CACHE[key]
