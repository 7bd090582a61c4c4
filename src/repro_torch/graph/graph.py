"""CSR graph container.

The whole substrate is host-side numpy (this mirrors the paper: graph
structure + features live in the DistGraph/KV-store host layer; only
per-batch blocks and features are shipped to the device).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed CSR graph (edges point from src -> dst; for GNN message
    passing we store the *incoming* adjacency: indices[indptr[v]:indptr[v+1]]
    are the in-neighbors u of v, i.e. messages u -> v)."""

    indptr: np.ndarray          # (n+1,) int64
    indices: np.ndarray         # (nnz,) int32  in-neighbor ids
    features: np.ndarray        # (n, d) float32
    labels: np.ndarray          # (n,) int32
    num_classes: int
    train_mask: Optional[np.ndarray] = None  # (n,) bool

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    @property
    def feat_dim(self) -> int:
        return int(self.features.shape[1])

    def in_degree(self) -> np.ndarray:
        return np.diff(self.indptr)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]: self.indptr[v + 1]]

    def validate(self) -> None:
        n = self.num_nodes
        assert self.indptr[0] == 0 and self.indptr[-1] == self.indices.shape[0]
        assert np.all(np.diff(self.indptr) >= 0), "indptr must be monotone"
        if self.num_edges:
            assert self.indices.min() >= 0 and self.indices.max() < n
        assert self.features.shape[0] == n
        assert self.labels.shape[0] == n

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   features: np.ndarray, labels: np.ndarray,
                   num_classes: int) -> "Graph":
        """Build in-CSR from an edge list (src -> dst)."""
        order = np.argsort(dst, kind="stable")
        dst_sorted = dst[order]
        src_sorted = src[order].astype(np.int32)
        counts = np.bincount(dst_sorted, minlength=num_nodes)
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return Graph(indptr=indptr, indices=src_sorted, features=features,
                     labels=labels, num_classes=num_classes)
