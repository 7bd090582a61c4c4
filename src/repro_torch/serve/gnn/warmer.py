"""Continuous hot-cache warmer for the serving tier (DESIGN.md §11).

The training cache is built from the precomputed schedule; serving has
no schedule, so the warmer closes the loop ONLINE: the service reports
every remote id it touches (``observe``), the warmer periodically ranks
the observed traffic with the same deterministic ``select_hot_set``
(freq desc, id asc) and bulk-loads the top ``n_hot`` rows via
``vector_pull`` -- the paper's VectorPull/C_sec machinery re-aimed at
request traffic. Each successful cycle publishes an immutable
``WarmSnapshot`` (global-id FeatureCache + CACHE_PAD-padded device
arrays in the service's one static shape) under the lock; the previous
snapshot is retained as the C_sec-style last-good buffer.

Failure semantics (the serving degradation contract): a transient
``serve_warm`` fault is retried with backoff inside the cycle; an
exhausted budget marks the warmer UNHEALTHY and keeps the last-good
snapshot installed -- the service flags responses ``stale=True`` until
a later cycle heals. The warm loop itself never dies to an injected
fault: errors are captured under the lock (THREAD-DISCIPLINE) and
surfaced typed via ``pending_error``/``warm_now``.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.cache import FeatureCache
from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.metrics import EpochMetrics
from repro_torch.core.schedule import select_hot_set
from repro_torch.dist.gnn_step import CACHE_PAD, DeviceView
from repro_torch.fault.inject import fault_point, retry_call
from repro_torch.serve.gnn.request import WarmerError


@dataclasses.dataclass(frozen=True)
class WarmSnapshot:
    """One published cache generation, immutable once installed."""
    generation: int
    cache: FeatureCache          # global-id snapshot (staleness contract)
    dev_ids: np.ndarray          # (n_hot,) int32 sorted, CACHE_PAD padded
    dev_feats: np.ndarray        # (n_hot, d) float32, zero rows at pads


class CacheWarmer:
    """Background thread turning observed traffic into hot snapshots."""

    #: bounded retry budget for transient warm-cycle faults
    warm_retries = 2
    retry_base_s = 1e-3

    def __init__(self, store: ShardedFeatureStore, dv: DeviceView,
                 n_hot: int, metrics: EpochMetrics,
                 interval_s: float = 0.05):
        self.store = store
        self.dv = dv
        self.n_hot = int(n_hot)
        self.metrics = metrics
        self.interval_s = float(interval_s)
        self.worker = store.worker
        self._lock = threading.Lock()          # traffic + published state
        self._err_lock = threading.Lock()
        self._freq: Dict[int, int] = {}
        self._current: Optional[WarmSnapshot] = None
        self._prev: Optional[WarmSnapshot] = None
        self._generation = 0
        self._healthy = True
        self._warm_failures = 0
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"serve-warmer-w{self.worker}")

    def start(self) -> "CacheWarmer":
        self._thread.start()
        return self

    # -- traffic observation (called by the service per micro-batch) -------
    def observe(self, remote_ids: np.ndarray) -> None:
        if remote_ids.shape[0] == 0:
            return
        ids, counts = np.unique(remote_ids, return_counts=True)
        with self._lock:
            for i, c in zip(ids.tolist(), counts.tolist()):
                self._freq[i] = self._freq.get(i, 0) + c

    # -- published state ----------------------------------------------------
    def snapshot(self) -> Tuple[Optional[WarmSnapshot], bool]:
        """-> (last published snapshot or None, healthy flag)."""
        with self._lock:
            return self._current, self._healthy

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def warm_failures(self) -> int:
        with self._lock:
            return self._warm_failures

    def pending_error(self) -> Optional[WarmerError]:
        """Last background-cycle failure, typed; cleared on read."""
        with self._err_lock:
            err, self._err = self._err, None
        if err is None:
            return None
        out = WarmerError("cache warm cycle failed")
        out.__cause__ = err
        return out

    # -- the warm cycle ------------------------------------------------------
    def warm_now(self) -> bool:
        """Synchronous cycle (deterministic tests / pre-warming): True if
        a new generation was published, False when there is no traffic
        yet. Raises typed ``WarmerError`` on an exhausted retry budget."""
        try:
            return self._warm_once()
        except BaseException as exc:
            with self._lock:
                self._healthy = False
                self._warm_failures += 1
            raise WarmerError("cache warm cycle failed") from exc

    def _warm_once(self) -> bool:
        with self._lock:
            if not self._freq:
                return False
            items = sorted(self._freq.items())   # id-ascending, unique
            gen = self._generation + 1
        ids = np.fromiter((k for k, _ in items), np.int64, len(items))
        freq = np.fromiter((v for _, v in items), np.int64, len(items))
        hot = select_hot_set(ids, freq, self.n_hot)

        def _attempt(a: int) -> np.ndarray:
            fault_point("serve_warm", attempt=a, epoch=gen,
                        worker=self.worker)
            return self.store.vector_pull(hot, self.metrics)

        feats = retry_call(_attempt, self.warm_retries, self.retry_base_s)
        snap = self._build_snapshot(gen, hot, feats)
        with self._lock:
            self._prev = self._current
            self._current = snap
            self._generation = gen
            self._healthy = True
        return True

    def _build_snapshot(self, gen: int, hot: np.ndarray,
                        feats: np.ndarray) -> WarmSnapshot:
        """Global snapshot + the (n_hot,) static device-space arrays the
        static-shape program consumes (sorted; CACHE_PAD tail never hits)."""
        dev = self.dv.g2d[hot]
        order = np.argsort(dev)
        k = hot.shape[0]
        dev_ids = np.full(self.n_hot, CACHE_PAD, np.int32)
        dev_feats = np.zeros((self.n_hot, self.store.d), np.float32)
        dev_ids[:k] = dev[order].astype(np.int32)
        dev_feats[:k] = feats[order].astype(np.float32)
        return WarmSnapshot(generation=gen,
                            cache=FeatureCache(hot, feats),
                            dev_ids=dev_ids, dev_feats=dev_feats)

    # -- thread lifecycle ----------------------------------------------------
    def _run(self) -> None:
        try:
            while not self._stop.wait(self.interval_s):
                try:
                    self._warm_once()
                except BaseException as exc:   # loop survives; degrade
                    with self._err_lock:
                        self._err = exc
                    with self._lock:
                        self._healthy = False
                        self._warm_failures += 1
        except BaseException as exc:           # never die silently
            with self._err_lock:
                self._err = exc

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent deadline-bounded teardown; a hung warmer raises a
        loud ``TimeoutError`` naming the thread, never a silent leak."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"warmer thread {self._thread.name} still alive "
                    f"after {timeout}s join deadline")
