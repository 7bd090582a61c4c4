"""Counts of one epoch's schedule, from which the yardstick works out
operations, bytes and the rows of the exchange.

``epoch_summary`` reads a schedule's packed arrays (per worker: the
batches' input nodes, seeds, per-layer dst counts, edges and masks,
and the hot set) and returns, per worker and batch: the input rows
``m``, the seeds, each layer's dst rows, unmasked edges and distinct
unmasked sources; and per worker the size of its hot set.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def _segment_sums(values: np.ndarray, starts: np.ndarray) -> np.ndarray:
    c = np.zeros(values.shape[0] + 1, np.int64)
    np.cumsum(values, out=c[1:])
    return c[starts[1:]] - c[starts[:-1]]


def worker_counts(flat: Any) -> Dict[str, np.ndarray]:
    m = np.diff(flat.input_starts).astype(np.int64)
    span = int(m.max()) + 1 if m.size else 1
    L = len(flat.edge_src)
    edges, uniq = [], []
    for l in range(L):
        st = flat.edge_starts[l]
        mask = flat.edge_mask[l]
        edges.append(_segment_sums(mask.astype(np.int64), st))
        # distinct sources over unmasked edges, batch by batch
        nb = st.shape[0] - 1
        seg = np.repeat(np.arange(nb, dtype=np.int64), np.diff(st))
        keys = seg[mask] * span + flat.edge_src[l][mask].astype(np.int64)
        uniq.append(np.bincount(np.unique(keys) // span, minlength=nb)
                    .astype(np.int64))
    return {"m": m, "seeds": np.diff(flat.seed_starts).astype(np.int64),
            "num_dst": np.asarray(flat.num_dst, np.int64).reshape(L, -1),
            "edges": np.stack(edges) if L else np.zeros((0, 0), np.int64),
            "uniq_src": np.stack(uniq) if L else np.zeros((0, 0), np.int64)}


def epoch_summary(flats: Sequence[Any], cache_ids: Sequence[np.ndarray]
                  ) -> Dict[str, Any]:
    """Per worker: ``worker_counts`` and the size of its hot set."""
    return {"workers": [worker_counts(f) for f in flats],
            "n_hot_used": [int(np.asarray(c).shape[0]) for c in cache_ids]}
