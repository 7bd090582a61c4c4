"""Double-buffered steady feature cache C_s / C_sec (paper §4 components 5-6).

The cache stores features of the top-``n_hot`` most frequently accessed
remote nodes for the current epoch, keyed by SORTED node id so lookup is a
binary search (``np.searchsorted`` host-side; the CUDA ``search`` kernel
of ``kernels/cache_lookup`` device-side). Buffer 1 (C_sec) for epoch e+1 is built concurrently
with training on epoch e and atomically swapped at the epoch boundary
(paper Alg. 1 line 18).

Memory bound (paper §3): 2 * n_hot * d floats for the two buffers.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np


class FeatureCache:
    """One buffer: sorted ids + aligned features."""

    def __init__(self, ids: np.ndarray, feats: np.ndarray):
        assert ids.ndim == 1 and feats.shape[0] == ids.shape[0]
        assert np.all(np.diff(ids) > 0), "cache ids must be sorted unique"
        self.ids = ids
        self.feats = feats

    @property
    def nbytes(self) -> int:
        return int(self.ids.nbytes + self.feats.nbytes)

    def lookup(self, query: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (positions, hit_mask); positions valid only where hit."""
        query = np.asarray(query)
        if self.ids.shape[0] == 0:      # indexing an empty table would raise
            return (np.zeros(query.shape, np.intp),
                    np.zeros(query.shape, bool))
        pos = np.searchsorted(self.ids, query)
        pos_c = np.minimum(pos, self.ids.shape[0] - 1)
        hit = self.ids[pos_c] == query
        return pos_c, hit

    def gather(self, query: np.ndarray, out: np.ndarray,
               hit: Optional[np.ndarray] = None) -> np.ndarray:
        pos, h = self.lookup(query)
        if hit is None:
            hit = h
        out[hit] = self.feats[pos[hit]]
        return hit


EMPTY = FeatureCache(np.zeros(0, np.int64), np.zeros((0, 1), np.float32))


class DoubleBufferCache:
    """C_s (buffer 0) serving lookups + C_sec (buffer 1) under construction."""

    def __init__(self, feat_dim: int):
        self.feat_dim = feat_dim
        self._steady: FeatureCache = EMPTY
        self._secondary: Optional[FeatureCache] = None
        self._lock = threading.Lock()

    @property
    def steady(self) -> FeatureCache:
        return self._steady

    def install_steady(self, cache: FeatureCache) -> None:
        with self._lock:
            self._steady = cache

    def stage_secondary(self, cache: FeatureCache) -> None:
        with self._lock:
            self._secondary = cache

    def swap(self) -> bool:
        """Atomic C_sec -> C_s at the epoch boundary. True if swapped."""
        with self._lock:
            if self._secondary is None:
                return False
            self._steady = self._secondary
            self._secondary = None
            return True

    @property
    def device_bytes(self) -> int:
        b = self._steady.nbytes
        if self._secondary is not None:
            b += self._secondary.nbytes
        return b
