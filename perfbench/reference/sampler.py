"""The deterministic schedule, worked out again batch by batch (paper
§3, Alg. 1 lines 1-3): each worker's train nodes shuffled by the stream
``H(s0, w, e, -1)``, cut into batches, and each batch's K-hop blocks
drawn uniformly with replacement from the stream ``H(s0, w, e, i)``,
output layer first; the hot set is the top ``n_hot`` remote ids of the
epoch by (frequency desc, id asc). The per-batch arithmetic of the
port's ``KHopSampler.sample_batch``, one batch at a time, with none of
its whole-epoch vectorisation."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from perfbench.rng import rng_from


@dataclasses.dataclass
class RefBatch:
    seeds: np.ndarray          # (B,) int64
    input_nodes: np.ndarray    # (m,) int64, dst-prefix order
    num_dst: List[int]         # per layer (input layer first)
    edge_src: List[np.ndarray]  # per layer, int32 local src index
    edge_dst: List[np.ndarray]  # per layer, int32 local dst index
    edge_mask: List[np.ndarray]  # per layer, bool


@dataclasses.dataclass
class RefEpoch:
    batches: List[RefBatch]
    cache_ids: np.ndarray      # sorted hot set (global ids)


def train_nodes(owner: np.ndarray, train_mask: np.ndarray,
                worker: int) -> np.ndarray:
    local = np.flatnonzero(owner == worker).astype(np.int64)
    return local[train_mask[local]]


def sample_batch(indptr: np.ndarray, indices: np.ndarray,
                 fanouts: Sequence[int], s0: int, worker: int, epoch: int,
                 index: int, seeds: np.ndarray) -> RefBatch:
    rng = rng_from(s0, worker, epoch, index)
    num_edges = indices.shape[0]
    cur = np.asarray(seeds, dtype=np.int64)
    rev = []
    for fanout in reversed(list(fanouts)):
        deg = (indptr[cur + 1] - indptr[cur]).astype(np.int64)
        nd = cur.shape[0]
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(nd, fanout))
        pos = indptr[cur][:, None] + offs
        src = indices[np.minimum(pos, num_edges - 1)].astype(np.int64)
        mask = np.broadcast_to((deg > 0)[:, None], (nd, fanout)).reshape(-1)
        src = src.reshape(-1)
        dst_idx = np.repeat(np.arange(nd, dtype=np.int32), fanout)
        src = np.where(mask, src, cur[dst_idx])
        extra = np.setdiff1d(np.unique(src), cur)
        src_nodes = np.concatenate([cur, extra])
        sorter = np.argsort(src_nodes, kind="stable")
        src_idx = sorter[np.searchsorted(src_nodes, src,
                                         sorter=sorter)].astype(np.int32)
        rev.append((nd, src_idx, dst_idx, np.ascontiguousarray(mask)))
        cur = src_nodes
    rev.reverse()
    return RefBatch(seeds=np.asarray(seeds, dtype=np.int64),
                    input_nodes=cur, num_dst=[r[0] for r in rev],
                    edge_src=[r[1] for r in rev],
                    edge_dst=[r[2] for r in rev],
                    edge_mask=[r[3] for r in rev])


def hot_set(batches: Sequence[RefBatch], owner: np.ndarray, worker: int,
            n_hot: int) -> np.ndarray:
    if not batches:
        return np.zeros(0, np.int64)
    nodes = np.concatenate([b.input_nodes for b in batches])
    remote = nodes[owner[nodes] != worker]
    if remote.size == 0:
        return np.zeros(0, np.int64)
    ids, freq = np.unique(remote, return_counts=True)
    k = min(n_hot, ids.shape[0])
    order = np.argsort(-freq, kind="stable")
    return np.sort(ids[order[:k]])


def sample_epoch(indptr: np.ndarray, indices: np.ndarray,
                 owner: np.ndarray, train_mask: np.ndarray,
                 fanouts: Sequence[int], batch_size: int, n_hot: int,
                 s0: int, worker: int, epoch: int) -> RefEpoch:
    tn = train_nodes(owner, train_mask, worker)
    perm = rng_from(s0, worker, epoch, -1).permutation(tn)
    nb = int(np.ceil(perm.shape[0] / batch_size))
    batches = [sample_batch(indptr, indices, fanouts, s0, worker, epoch, i,
                            perm[i * batch_size:(i + 1) * batch_size])
               for i in range(nb)]
    return RefEpoch(batches=batches,
                    cache_ids=hot_set(batches, owner, worker, n_hot))


def miss_counts(input_nodes: np.ndarray, owner: np.ndarray, worker: int,
                cache_ids: np.ndarray, num_parts: int) -> np.ndarray:
    """(P,) rows one batch of ``worker`` pulls from each owner: its
    remote input nodes that are not in its hot set."""
    remote = owner[input_nodes] != worker
    miss = remote & ~np.isin(input_nodes, cache_ids)
    return np.bincount(owner[input_nodes[miss]], minlength=num_parts)
