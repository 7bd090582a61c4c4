"""Hot-token embedding cache: RapidGNN's technique on the vocab table,
the port of ``repro/models/transformer/embedding.py``.

A vocab-sharded embedding table is the transformer's "distributed KV
store" -- every token id is a remote feature fetch unless its row lives
locally. Token ids are Zipf-distributed (long tail), and the
deterministic data schedule (``data/pipeline.py``) makes the access
counts of a whole run enumerable OFFLINE, exactly like the paper's
Alg. 1 lines 1-3. So each worker:

  1. enumerates its run's token-access counts (offline),
  2. VectorPulls the top-n_hot non-local rows into a device cache,
  3. serves batches cache-first; only residual misses ride the
     all-to-all pull.

The device data path reuses the GNN core's machinery:
``dist.feature_a2a.pull_features`` for the pull and ``cache_gather``
(the ``search`` and ``merge_gather`` kernels on the card) for the hit
path. ``HotEmbeddingSim`` (numpy, copied from the reference) provides
host-side accounting (bytes/RPC reduction -- paper Fig. 4/5 on the
embedding workload).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class HotEmbeddingSim:
    vocab: int
    d: int
    num_workers: int
    n_hot: int
    counts: np.ndarray          # (vocab,) offline access counts

    def __post_init__(self):
        per = (self.vocab + self.num_workers - 1) // self.num_workers
        self.owner = np.minimum(np.arange(self.vocab) // per,
                                self.num_workers - 1)
        # per-worker hot set: most-accessed REMOTE ids (paper N_cache)
        self.cache = []
        for w in range(self.num_workers):
            remote = np.flatnonzero(self.owner != w)
            order = remote[np.argsort(-self.counts[remote],
                                      kind="stable")]
            self.cache.append(np.sort(order[: self.n_hot]))

    def batch_traffic(self, tokens: np.ndarray, worker: int
                      ) -> Tuple[int, int, int]:
        """-> (baseline_bytes, cached_bytes, hits) for one batch on one
        worker. Baseline = every unique remote id fetched (DGL-style,
        already deduped -- favourable to the baseline)."""
        uniq = np.unique(tokens)
        remote = uniq[self.owner[uniq] != worker]
        hits = np.isin(remote, self.cache[worker],
                       assume_unique=True).sum()
        row = self.d * 4
        return remote.size * row, int((remote.size - hits) * row), int(hits)

    def cache_build_bytes(self) -> int:
        return self.n_hot * self.d * 4


def device_embedding_lookup(mesh, table: torch.Tensor,
                            cache_ids: torch.Tensor,
                            cache_feats: torch.Tensor, tokens: torch.Tensor,
                            plan, m_max: int) -> torch.Tensor:
    """Device path: all-to-all residual pull, then a cache-first merge.

    table (P, V/P, d) vocab-sharded; cache_ids (P, n_hot) sorted int32
    (INT32_MAX padded); cache_feats (P, n_hot, d); tokens (P, m) int32;
    plan a dict of ``send_ids``/``send_pos``/``send_mask`` (P, P, k) lanes
    for the residual misses (built offline from the deterministic
    schedule) and ``offsets`` (P,); m_max == m -> (P, m, d) embedding
    rows. One ``pull_features`` exchange, then one ``cache_gather`` per
    worker.
    """
    from repro_torch.dist.feature_a2a import cache_gather, pull_features
    pulled = pull_features(mesh, table, plan["send_ids"], plan["send_pos"],
                           plan["send_mask"], plan["offsets"], m_max)
    return torch.stack([
        cache_gather(cache_ids[w], cache_feats[w], tokens[w], pulled[w])[0]
        for w in range(table.shape[0])])
