"""End-to-end runners: RapidGNN (Alg. 1) vs on-demand baseline (DGL-style).

Both runners consume the SAME deterministic schedule, collation, and
train_fn, so every measured difference is attributable to the paper's
technique (cache + prefetch pipeline) and not to incidental implementation
drift. The baseline fetches every remote feature of every batch
synchronously on the critical path with no cache and no overlap -- the
DGL on-the-fly KV-pull data path the paper compares against.

The port's own copy of the JAX package's ``repro.core.runtime``, kept
bit-identical to it; ``train_fn`` is the port's torch step.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.cache import DoubleBufferCache, FeatureCache
from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.metrics import EpochMetrics, NetworkModel, RunMetrics
from repro_torch.core.prefetch import (Prefetcher, PrefetchStall,
                                       PrefetchWorkerError,
                                       SecondaryCacheBuilder,
                                       SecondaryCacheError, StagedBatch,
                                       assemble_features, local_fill)
from repro_torch.core.schedule import WorkerSchedule, collate

TrainFn = Callable[[np.ndarray, "CollatedBatch"], float]  # noqa: F821


def global_pad_bounds(ws: WorkerSchedule):
    """Static shapes across ALL epochs -> one padded shape per run.

    Served from the schedule's build-time (m_max, edge_maxima) metadata
    cache, so spilled epochs are never re-loaded for pad bounds."""
    return ws.pad_bounds()


class RapidGNNRunner:
    """Alg. 1 consumer with supervision (DESIGN.md §10):

    * ``stall_timeout_s`` bounds each queue wait; on expiry the trainer
      rebuilds the batch on the critical path (``default_path`` counts
      it) from the SAME deterministic schedule, so a late/hung producer
      costs wall time, never changes the loss curve. ``None`` (default)
      keeps the historical blocking behavior.
    * a failed C_sec build degrades: the stale steady cache is kept for
      the next epoch (``csec_degraded`` counts it) -- lossless, since
      the cache only redirects fetches, never alters feature values.
    * producer joins are deadline-bounded (``join_timeout_s``); a hung
      thread raises a loud ``TimeoutError`` naming it.
    """

    def __init__(self, ws: WorkerSchedule, store: ShardedFeatureStore,
                 batch_size: int, Q: int = 4,
                 train_fn: Optional[TrainFn] = None,
                 stall_timeout_s: Optional[float] = None,
                 join_timeout_s: float = 30.0):
        self.ws = ws
        self.store = store
        self.batch_size = batch_size
        self.Q = Q
        self.train_fn = train_fn or (lambda feats, cb: 0.0)
        self.stall_timeout_s = stall_timeout_s
        self.join_timeout_s = join_timeout_s
        self.dbc = DoubleBufferCache(store.d)
        self.m_max, self.edge_max = global_pad_bounds(ws)
        self.metrics = RunMetrics()

    def _build_batch(self, es, i: int, labels, m: EpochMetrics
                     ) -> StagedBatch:
        """Critical-path fallback: rebuild batch ``i`` exactly as the
        prefetcher would have (same schedule, same cache, same pull set)
        when the trainer outruns or outlives the producer."""
        b = es.batches[i]
        cb = collate(b, labels, self.batch_size, self.m_max,
                     self.edge_max)
        feats = assemble_features(cb, self.store, self.dbc.steady, m,
                                  critical_path=True)
        return StagedBatch(i, cb, feats, 0.0)

    def run(self) -> RunMetrics:
        labels = self.store.pg.graph.labels
        n_epochs = len(self.ws.epochs)

        # initial steady cache: ONE VectorPull before epoch 0 (Alg.1 l.4)
        es0 = self.ws.epoch(0)
        boot = EpochMetrics(epoch=-1)
        feats0 = self.store.vector_pull(es0.cache_ids, boot)
        self.dbc.install_steady(FeatureCache(es0.cache_ids, feats0))

        for e in range(n_epochs):
            es = self.ws.epoch(e)
            m = EpochMetrics(epoch=e)
            if e == 0:   # charge the bootstrap pull to epoch 0
                m.vector_pull_bytes += boot.vector_pull_bytes
                m.modeled_net_time_s += boot.modeled_net_time_s
            t_epoch = time.perf_counter()

            builder = None
            if e + 1 < n_epochs:        # build C_sec for e+1 in parallel
                builder = SecondaryCacheBuilder(self.ws.epoch(e + 1),
                                                self.store, self.dbc,
                                                m).start()
            pf = Prefetcher(es, self.store, self.dbc, labels,
                            self.batch_size, self.m_max, self.edge_max,
                            self.Q, m).start()
            try:
                expect, n_batches = 0, es.num_batches
                while expect < n_batches:
                    t0 = time.perf_counter()
                    try:
                        staged = pf.get(timeout=self.stall_timeout_s)
                    except PrefetchStall:
                        # producer late/hung: rebuild batch `expect` on
                        # the critical path -- deterministic, so the
                        # loss curve is unchanged (DESIGN.md §10)
                        m.fetch_stall_s += time.perf_counter() - t0
                        staged = self._build_batch(es, expect, labels, m)
                        m.default_path += 1
                    else:
                        m.fetch_stall_s += time.perf_counter() - t0
                        if staged is None:
                            raise PrefetchWorkerError(
                                f"prefetcher ended early at batch "
                                f"{expect}/{n_batches}")
                        if staged.index < expect:
                            continue    # duplicate of a fallback batch
                        m.prefetch_hits += 1
                    t1 = time.perf_counter()
                    self.train_fn(staged.features, staged.collated)
                    m.compute_time_s += time.perf_counter() - t1
                    expect += 1
                # drain to the sentinel: a producer that fell behind the
                # fallback path may still deliver tail batches (a stall
                # HERE means it is hung -> bounded get raises typed)
                while pf.get(timeout=self.join_timeout_s) is not None:
                    pass
                pf.join(timeout=self.join_timeout_s)
                if builder is not None:
                    try:
                        builder.join(timeout=self.join_timeout_s)
                    except SecondaryCacheError:
                        # degraded mode: keep the stale steady cache for
                        # e+1 (swap() no-ops without a staged C_sec);
                        # lossless -- only the miss accounting shifts
                        m.csec_degraded += 1
            except BaseException:
                # unblock + bound both producers before propagating, so a
                # train_fn failure can't leak a thread wedged on a full
                # queue or an un-reaped C_sec pull
                pf.close()
                if builder is not None:
                    builder.close()
                raise
            self.dbc.swap()             # C_sec -> C_s (Alg.1 l.18)
            m.wall_time_s = time.perf_counter() - t_epoch
            self.metrics.epochs.append(m)
        return self.metrics

    @property
    def device_cache_bytes(self) -> int:
        return self.dbc.device_bytes


def occurrence_remote_ids(batch, owner: np.ndarray,
                          worker: int) -> np.ndarray:
    """Every remote node reference in a SampledBatch, one entry per
    unmasked edge-level occurrence (a node sampled k times appears k
    times). Every non-seed input node enters the batch through at least
    one unmasked edge, so this is always a multiset superset of the
    batch's unique remote set."""
    refs = [batch.input_nodes[blk.edge_src[blk.edge_mask]]
            for blk in batch.blocks]
    cat = (np.concatenate(refs) if refs
           else np.zeros(0, batch.input_nodes.dtype))
    return cat[owner[cat] != worker]


class BaselineRunner:
    """DGL-style on-demand path: synchronous un-cached remote fetch.

    ``dedupe=False`` additionally models per-request redundancy ("frequent
    and redundant RPC calls", paper §2.3) by charging each remote id once
    per occurrence rather than once per batch -- we keep dedupe=True by
    default, which is FAVOURABLE to the baseline.
    """

    def __init__(self, ws: WorkerSchedule, store: ShardedFeatureStore,
                 batch_size: int, train_fn: Optional[TrainFn] = None,
                 dedupe: bool = True):
        self.ws = ws
        self.store = store
        self.batch_size = batch_size
        self.train_fn = train_fn or (lambda feats, cb: 0.0)
        self.dedupe = dedupe
        self.m_max, self.edge_max = global_pad_bounds(ws)
        self.metrics = RunMetrics()

    def _assemble_per_occurrence(self, b, cb, m: EpochMetrics) -> np.ndarray:
        """dedupe=False fetch: charge bytes/RPCs for every edge-level
        occurrence of a remote node (redundant-RPC regime), then fill the
        buffer once per unique slot. The charged occurrence multiset is a
        superset of the unique remote set, so the filled rows' bytes are
        fully accounted."""
        store = self.store
        out, rem_idx = local_fill(cb, store)
        occ = occurrence_remote_ids(b, store.pg.owner, store.worker)
        m.remote_requests += int(occ.shape[0])
        m.cache_misses += int(occ.shape[0])
        if occ.shape[0]:
            store.sync_pull(occ, m, critical_path=True)
        if rem_idx.shape[0]:
            out[rem_idx] = store.feat[cb.input_nodes[rem_idx]]
        return out

    def run(self) -> RunMetrics:
        labels = self.store.pg.graph.labels
        for e in range(len(self.ws.epochs)):
            es = self.ws.epoch(e)
            m = EpochMetrics(epoch=e)
            t_epoch = time.perf_counter()
            for b in es.batches:
                t0 = time.perf_counter()
                cb = collate(b, labels, self.batch_size, self.m_max,
                             self.edge_max)
                if self.dedupe:
                    feats = assemble_features(cb, self.store, cache=None,
                                              m=m, critical_path=True)
                else:
                    feats = self._assemble_per_occurrence(b, cb, m)
                m.fetch_stall_s += time.perf_counter() - t0
                t1 = time.perf_counter()
                self.train_fn(feats, cb)
                m.compute_time_s += time.perf_counter() - t1
            m.wall_time_s = time.perf_counter() - t_epoch
            self.metrics.epochs.append(m)
        return self.metrics
