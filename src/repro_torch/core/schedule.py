"""Host-side schedule pieces the serving slice needs (paper §3).

The port's own copy of three members of the JAX package's
``repro.core.schedule``: ``select_hot_set`` (the deterministic
(freq desc, id asc) hot-set ranking the cache warmer uses),
``CollatedBatch`` and ``collate`` (the static-shape padded batch every
kernel launch consumes). They stay bit-identical to the reference; the
epoch schedule compiler and its spill machinery come with the training
slice.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.sampler import SampledBatch


def select_hot_set(remote_ids: np.ndarray, remote_freq: np.ndarray,
                   n_hot: int,
                   weight: Optional[np.ndarray] = None) -> np.ndarray:
    """Top-``n_hot`` remote ids by (freq desc, id asc), returned SORTED.

    The lexicographic tie-break is load-bearing: ``argpartition`` (the
    historical selection) breaks frequency ties arbitrarily across numpy
    versions/platforms, and a schedule whose C_s depends on partition
    internals is not the paper's deterministic schedule (Prop 3.1).
    ``remote_ids`` arrives ascending (``np.unique`` output), so a STABLE
    sort on descending frequency realises (-freq, id) order exactly.

    ``weight`` (aligned with ``remote_ids``) multiplies the frequency
    before ranking -- the topology-aware admission bias (DESIGN.md
    §6.7): cross-DCN owners get ``weight > 1`` so the cache preferably
    saves the expensive fetches. ``weight=None`` (and any all-equal
    weight) leaves the selection bit-identical to the unbiased path.
    """
    k = min(n_hot, remote_ids.shape[0])
    if k <= 0:
        return np.zeros(0, np.int64)
    eff = remote_freq if weight is None \
        else remote_freq.astype(np.float64) * weight
    order = np.argsort(-eff, kind="stable")
    return np.sort(remote_ids[order[:k]])


@dataclasses.dataclass
class CollatedBatch:
    """Static-shape batch: every array padded to epoch-level maxima.
    Padded input-node slots carry id -1 and are masked everywhere."""
    seeds: np.ndarray          # (B,) int32, -1 padded
    seed_mask: np.ndarray      # (B,) bool
    labels: np.ndarray         # (B,) int32
    input_nodes: np.ndarray    # (m_max,) int64, -1 padded
    input_mask: np.ndarray     # (m_max,) bool
    num_inputs: int
    # per layer: (E_max,) arrays
    edge_src: List[np.ndarray]
    edge_dst: List[np.ndarray]
    edge_mask: List[np.ndarray]
    num_dst: List[int]         # true dst count per layer (static per batch)


def collate(batch: SampledBatch, labels: np.ndarray, batch_size: int,
            m_max: int, edge_max: Sequence[int]) -> CollatedBatch:
    b = batch
    m = b.num_input_nodes
    inp = np.full(m_max, -1, dtype=np.int64)
    inp[:m] = b.input_nodes
    imask = np.zeros(m_max, dtype=bool)
    imask[:m] = True

    B = b.seeds.shape[0]
    seeds = np.full(batch_size, -1, dtype=np.int64)
    seeds[:B] = b.seeds
    smask = np.zeros(batch_size, dtype=bool)
    smask[:B] = True
    lab = np.zeros(batch_size, dtype=np.int32)
    lab[:B] = labels[b.seeds]

    es, ed, em, ndst = [], [], [], []
    for l, blk in enumerate(b.blocks):
        E = blk.edge_src.shape[0]
        pe = np.zeros(edge_max[l], dtype=np.int32)
        pd = np.zeros(edge_max[l], dtype=np.int32)
        pm = np.zeros(edge_max[l], dtype=bool)
        pe[:E] = blk.edge_src
        pd[:E] = blk.edge_dst
        pm[:E] = blk.edge_mask
        es.append(pe)
        ed.append(pd)
        em.append(pm)
        ndst.append(blk.num_dst)
    return CollatedBatch(seeds=seeds, seed_mask=smask, labels=lab,
                         input_nodes=inp, input_mask=imask, num_inputs=m,
                         edge_src=es, edge_dst=ed, edge_mask=em,
                         num_dst=ndst)
