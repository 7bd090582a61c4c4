"""Device relabelling of a partitioned graph (host side, numpy).

The port's own copy of ``CACHE_PAD``, ``DeviceCache`` and ``DeviceView``
from the JAX package's ``repro.dist.gnn_step``: the serving slice needs
the contiguous per-worker device-id space (ownership is ``id // n_per``)
and the int32 cache sentinel. The epoch programs of that module come
with the training slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.partition import PartitionedGraph

#: int64 cache padding; survives the int32 cast exactly and matches the
#: ``search`` kernel's sentinel (``kernels/cache_lookup``).
CACHE_PAD = int(2 ** 31 - 1)


@dataclasses.dataclass
class DeviceCache:
    """One worker's hot set C_s in DEVICE id space, sorted for searchsorted."""
    ids: np.ndarray      # (k,) int64 device ids, sorted unique
    feats: np.ndarray    # (k, d) float32


@dataclasses.dataclass
class DeviceView:
    """Device relabeling of a PartitionedGraph.

    Partitions own arbitrary global-id sets; the device path needs
    ownership decidable by arithmetic (``owner = id // n_per``) so the
    pull can turn an id into (owner, slot) with no lookup table on
    device. ``build`` assigns worker p's nodes the dense device ids
    ``p * n_per + [0..|V_p|)`` with ``n_per = max_p |V_p|`` (tail slots
    of smaller partitions are zero rows, never referenced).
    """
    num_parts: int
    n_per: int
    table: np.ndarray      # (P, n_per, d) float32, partition-sharded rows
    offsets: np.ndarray    # (P, 1) int32   first device slot per worker
    g2d: np.ndarray        # (n,) int64     global id -> device id
    features: np.ndarray   # (n, d)         global table (host ref, not copied)

    @staticmethod
    def build(pg: PartitionedGraph) -> "DeviceView":
        g = pg.graph
        P_ = pg.num_parts
        n_per = int(max(ln.shape[0] for ln in pg.local_nodes))
        table = np.zeros((P_, n_per, g.feat_dim), np.float32)
        g2d = np.empty(g.num_nodes, np.int64)
        for p, loc in enumerate(pg.local_nodes):
            table[p, : loc.shape[0]] = g.features[loc]
            g2d[loc] = p * n_per + np.arange(loc.shape[0], dtype=np.int64)
        offsets = (np.arange(P_, dtype=np.int32) * n_per)[:, None]
        return DeviceView(num_parts=P_, n_per=n_per, table=table,
                          offsets=offsets, g2d=g2d, features=g.features)

    @property
    def owner_d(self) -> np.ndarray:
        """(P*n_per,) device-id -> owner, for build_pull_plan."""
        return np.repeat(np.arange(self.num_parts, dtype=np.int32),
                         self.n_per)

    def remap_cache(self, cache_ids_global: np.ndarray) -> DeviceCache:
        """Global hot-set ids (schedule output) -> sorted device cache."""
        dev = self.g2d[cache_ids_global]
        order = np.argsort(dev)
        return DeviceCache(
            ids=dev[order],
            feats=self.features[cache_ids_global[order]].astype(np.float32))
