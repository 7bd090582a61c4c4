"""Rolling prefetcher + secondary-cache builder (paper §4 components 4,6,7).

The prefetcher is a real producer thread staging device-ready batches
(collated metadata + assembled feature tensor) into a bounded queue of
depth Q -- the paper's MPMC ring. It is *cache-first*: features are served
from C_s, and only the residual miss set M_i goes through SyncPull. The
queue blocks when full (prefetcher ahead) and the trainer stalls when it
outruns the queue (the Prefetcher-Trainer race the paper describes); stall
time is metered separately as critical-path fetch time.

The port's own copy of the JAX package's ``repro.core.prefetch``, kept
bit-identical to it. The threads here touch numpy only: every CUDA call
of a training run stays on the thread that runs ``train_fn``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

import numpy as np

from repro_torch.core.cache import DoubleBufferCache, FeatureCache
from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.metrics import EpochMetrics
from repro_torch.core.schedule import (CollatedBatch, EpochSchedule,
                                       collate, epoch_edge_maxima)
from repro_torch.fault.inject import fault_point, retry_call


class PrefetchWorkerError(RuntimeError):
    """The prefetch thread died (non-retryable failure or retry budget
    exhausted); the original exception rides along as ``__cause__``."""


class SecondaryCacheError(RuntimeError):
    """The C_sec builder thread died; the consumer may degrade (keep the
    stale steady cache -- lossless, counted) instead of failing the run."""


class PrefetchStall(TimeoutError):
    """``Prefetcher.get(timeout=)`` expired: the producer is late or
    hung. The consumer can fall back to a critical-path batch rebuild
    (``RapidGNNRunner`` does) -- determinism is unaffected either way."""


class StagedBatch:
    __slots__ = ("index", "collated", "features", "fetch_time")

    def __init__(self, index: int, collated: CollatedBatch,
                 features: np.ndarray, fetch_time: float):
        self.index = index
        self.collated = collated
        self.features = features
        self.fetch_time = fetch_time


def local_fill(cb: CollatedBatch, store: ShardedFeatureStore):
    """Zeroed (m_max, d) buffer with this worker's LOCAL rows filled.

    -> (out, rem_idx): rem_idx indexes the valid REMOTE slots still to be
    served (padded -1 slots are neither local nor remote). Shared by the
    cache-first assembly below and the baseline's per-occurrence path so
    both fill local rows identically."""
    ids = cb.input_nodes
    valid = cb.input_mask
    out = np.zeros((ids.shape[0], store.d), dtype=store.feat.dtype)
    safe_ids = np.where(valid, ids, 0)
    is_local = (store.pg.owner[safe_ids] == store.worker) & valid
    if is_local.any():
        out[is_local] = store.local_read(safe_ids[is_local])
    return out, np.flatnonzero(valid & ~is_local)


def assemble_features(cb: CollatedBatch, store: ShardedFeatureStore,
                      cache: Optional[FeatureCache], m: EpochMetrics,
                      critical_path: bool) -> np.ndarray:
    """Cache-first feature materialization for one batch (Alg.1 l.12-15)."""
    ids = cb.input_nodes
    out, rem_idx = local_fill(cb, store)
    n_remote = int(rem_idx.shape[0])
    m.remote_requests += n_remote
    if n_remote == 0:
        return out

    rem_ids = ids[rem_idx]
    if cache is not None and cache.ids.shape[0] > 0:
        pos, hit = cache.lookup(rem_ids)
        out[rem_idx[hit]] = cache.feats[pos[hit]]
        m.cache_hits += int(hit.sum())
        miss_idx = rem_idx[~hit]
    else:
        miss_idx = rem_idx
    m.cache_misses += int(miss_idx.shape[0])
    if miss_idx.shape[0]:
        out[miss_idx] = store.sync_pull(ids[miss_idx], m,
                                        critical_path=critical_path)
    return out


class Prefetcher:
    """Producer thread staging the next Q batches (paper Alg. 1 line 10).

    Supervision (DESIGN.md §10): a transiently-failing batch build is
    retried in place with exponential backoff (``max_retries``, counted
    in ``metrics.prefetch_retries``); a persistent/fatal failure lands
    in ``_err`` and surfaces TYPED (``PrefetchWorkerError``) at the
    sentinel or join. ``join`` is deadline-bounded and names the stuck
    thread, so a hung producer can never deadlock runner teardown."""

    #: bounded retry budget for transient per-batch build failures
    max_retries = 2
    retry_base_s = 1e-3

    def __init__(self, es: EpochSchedule, store: ShardedFeatureStore,
                 dbc: DoubleBufferCache, labels: np.ndarray,
                 batch_size: int, m_max: int, edge_max: List[int],
                 Q: int, metrics: EpochMetrics):
        self.es = es
        self.store = store
        self.dbc = dbc
        self.labels = labels
        self.batch_size = batch_size
        self.m_max = m_max
        self.edge_max = edge_max
        self.q: "queue.Queue[Optional[StagedBatch]]" = queue.Queue(maxsize=Q)
        self.metrics = metrics
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"prefetch-w{store.worker}-e{es.epoch}")

    def start(self) -> "Prefetcher":
        self._thread.start()
        return self

    def _build(self, i: int, b, attempt: int) -> StagedBatch:
        # the fault probe sits BEFORE assembly so a retried attempt
        # never double-counts hit/miss/byte metrics
        fault_point("prefetch", attempt=attempt, epoch=self.es.epoch,
                    worker=self.store.worker, index=i)
        t0 = time.perf_counter()
        cb = collate(b, self.labels, self.batch_size, self.m_max,
                     self.edge_max)
        feats = assemble_features(cb, self.store, self.dbc.steady,
                                  self.metrics, critical_path=False)
        return StagedBatch(i, cb, feats, time.perf_counter() - t0)

    def _count_retry(self, _attempt: int) -> None:
        self.metrics.prefetch_retries += 1

    def _run(self) -> None:
        try:
            for i, b in enumerate(self.es.batches):
                if self._stop.is_set():
                    return
                staged = retry_call(
                    lambda a, _i=i, _b=b: self._build(_i, _b, a),
                    self.max_retries, self.retry_base_s,
                    on_retry=self._count_retry)
                self._put(staged)
        except BaseException as exc:          # re-raised in get()/join()
            with self._err_lock:
                self._err = exc
        finally:
            self._put(None)                   # epoch sentinel / unblock

    def _put(self, item: Optional[StagedBatch]) -> None:
        # bounded put that yields to close(): never deadlocks on a full
        # queue after the consumer has gone away
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def get(self, timeout: Optional[float] = None) -> Optional[StagedBatch]:
        try:
            item = self.q.get(timeout=timeout)
        except queue.Empty:
            raise PrefetchStall(
                f"prefetch thread {self._thread.name} produced nothing "
                f"within {timeout}s") from None
        if item is None:
            self._raise_pending()
        return item

    def join(self, timeout: Optional[float] = 30.0) -> None:
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"prefetch thread {self._thread.name} still alive after "
                f"{timeout}s join deadline")
        self._raise_pending()

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent exception-path teardown: drains the bounded queue so
        a blocked producer exits, then joins it with a deadline."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.ident is not None:
            self._thread.join(timeout=timeout)

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise PrefetchWorkerError("prefetch thread failed") from err


class SecondaryCacheBuilder:
    """Builds C_sec for epoch e+1 concurrently (paper Alg. 1 lines 7-9).

    A failed build surfaces as ``SecondaryCacheError`` at join; the
    consumer may degrade by keeping the stale steady cache (``swap()``
    no-ops without a staged secondary -- lossless, since the cache only
    redirects fetches). A HUNG build is NOT degradable: the bounded
    join raises a loud ``TimeoutError`` naming the thread."""

    def __init__(self, next_es: EpochSchedule, store: ShardedFeatureStore,
                 dbc: DoubleBufferCache, metrics: EpochMetrics):
        self.next_es = next_es
        self.store = store
        self.dbc = dbc
        self.metrics = metrics
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"csec-w{store.worker}-e{metrics.epoch}")

    def start(self) -> "SecondaryCacheBuilder":
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            fault_point("csec", epoch=self.metrics.epoch,
                        worker=self.store.worker)
            ids = self.next_es.cache_ids
            feats = self.store.vector_pull(ids, self.metrics)
            self.dbc.stage_secondary(FeatureCache(ids, feats))
        except BaseException as exc:          # re-raised in join()
            with self._err_lock:
                self._err = exc

    def join(self, timeout: Optional[float] = 30.0) -> None:
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"secondary-cache thread {self._thread.name} still alive "
                f"after {timeout}s join deadline")
        self._raise_pending()

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent exception-path join (does not re-raise)."""
        if self._closed:
            return
        self._closed = True
        if self._thread.ident is not None:
            self._thread.join(timeout=timeout)

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise SecondaryCacheError(
                "secondary cache build failed") from err
