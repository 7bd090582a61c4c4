"""Online batched GNN inference service (DESIGN.md §11), on PyTorch.

One process, one worker's view of the partitioned graph, one static
layout: requests admitted past the bounded queue are collated into a
static ``(R, m_max)`` micro-batch, features are assembled by the fused
assembly the trainer uses -- local shard > hot cache > pulled residuals,
flattened to one ``assemble_features`` call (one fused kernel on CUDA,
which ranks each row over the hot set itself) -- and a batched
``forward`` (the ``gather_agg`` kernel per layer under
``agg_backend="kernel"``) produces per-request logits.

Robustness ladder (every failure is typed or degrades, never silent):

  admission   queue past high-water  -> typed ``Overloaded`` (shed)
  fresh       healthy warmer         -> current hot snapshot
  stale       warmer down            -> last-good snapshot, ``stale=True``
                                        (bit-equal for cache-resident
                                        rows; table is immutable)
  uncached    no snapshot yet        -> every remote row sync-pulled
  pull        transient serve_pull   -> ``retry_call`` backoff; exhausted
                                        budget fails THAT request typed
                                        (``ServePullError``)
  deadline    remaining < slack      -> retries dropped to fail fast
                                        (backoff would blow the budget);
                                        late completions are counted
                                        ``deadline_miss``, still correct

The response carries tier + snapshot provenance, so the staleness
contract -- non-shed responses bit-equal to the clean single-request
oracle, or flagged stale with features bit-equal to the snapshot served
from -- is checkable per response.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.metrics import EpochMetrics, NetworkModel
from repro_torch.device import resolve_device
from repro_torch.dist.gnn_step import CACHE_PAD, DeviceView
from repro_torch.dist.runner import shape_key
from repro_torch.fault.inject import fault_point, retry_call
from repro_torch.fault.plan import InjectedFault
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.graph.sampler import KHopSampler
from repro_torch.kernels.assemble.ops import assemble_features
from repro_torch.models.gnn import GNNConfig, Params, forward, params_to
from repro_torch.serve.gnn.admission import AdmissionQueue
from repro_torch.serve.gnn.collator import (SERVE_EPOCH, MicroBatch,
                                            ServeCollator)
from repro_torch.serve.gnn.request import (TIER_FRESH, TIER_STALE,
                                           TIER_UNCACHED, InferenceRequest,
                                           InferenceResponse,
                                           PendingResponse, ServeClosed,
                                           ServePullError)
from repro_torch.serve.gnn.warmer import CacheWarmer, WarmSnapshot


class ServeProgram:
    """The inference program: a plain callable that moves one
    micro-batch to the device, runs ``assemble_features`` then the
    batched ``forward``, and returns numpy logits.

    One program can serve several services of the same static shapes
    (the chaos sweep hands every faulted run the same program).
    ``trace_count`` is the number of distinct static input shapes it was
    called with, counted as the device runner counts them (the
    reference's count of XLA traces): a static-shape service keeps it at
    1."""

    def __init__(self, cfg: GNNConfig, max_requests: int, m_max: int,
                 batch_size: int, d: int, base: int, device: torch.device):
        self.cfg = cfg
        self.max_requests = max_requests
        self.m_max = m_max
        self.batch_size = batch_size
        self.d = d
        self.base = base
        self.device = device
        self._shape_keys: set = set()

    @property
    def key(self) -> Tuple:
        """The static shape a service must have to share this program."""
        return (self.cfg, self.max_requests, self.m_max, self.batch_size,
                self.d, self.base, self.device)

    @property
    def trace_count(self) -> int:
        return len(self._shape_keys)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def __call__(self, params: Params, table: torch.Tensor,
                 cache_ids: np.ndarray, cache_feats: np.ndarray,
                 query: np.ndarray, pulled: np.ndarray,
                 edge_src: Sequence[np.ndarray],
                 edge_dst: Sequence[np.ndarray],
                 edge_mask: Sequence[np.ndarray]) -> np.ndarray:
        x = {"cache_ids": self._dev(cache_ids),
             "cache_feats": self._dev(cache_feats),
             "query": self._dev(query), "pulled": self._dev(pulled),
             "edge_src": [self._dev(e) for e in edge_src],
             "edge_dst": [self._dev(e) for e in edge_dst],
             "edge_mask": [self._dev(e) for e in edge_mask]}
        self._shape_keys.add(shape_key(x))
        with torch.inference_mode():
            flat = assemble_features(
                table, self.base, x["cache_ids"], x["cache_feats"],
                x["query"].reshape(-1), x["pulled"].reshape(-1, self.d))
            h = flat.reshape(self.max_requests, self.m_max, self.d)
            logits = forward(self.cfg, params, h, x["edge_src"],
                             x["edge_dst"], x["edge_mask"])
            return logits[:, :self.batch_size].cpu().numpy()


class GNNInferenceService:
    """Admission queue -> collator -> fused assembly -> batched forward.

    Runs on ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"`` is asked for). ``program`` reuses another service's
    ``ServeProgram`` of the same static shapes."""

    def __init__(self, pg: PartitionedGraph, sampler: KHopSampler,
                 cfg: GNNConfig, params: Params, *, s0: int = 0,
                 worker: int = 0, n_hot: int = 256,
                 max_batch_requests: int = 4, high_water: int = 64,
                 default_timeout_s: float = 1.0,
                 pressure_slack_s: float = 0.02,
                 warm_interval_s: float = 0.05,
                 net: Optional[NetworkModel] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 program: Optional[ServeProgram] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.worker = int(worker)
        self.default_timeout_s = float(default_timeout_s)
        self.pressure_slack_s = float(pressure_slack_s)

        self.dv = DeviceView.build(pg)
        self.store = ShardedFeatureStore(pg, self.worker, net=net)
        self.metrics = EpochMetrics(epoch=SERVE_EPOCH)
        self.collator = ServeCollator(sampler, s0, self.worker,
                                      max_batch_requests)
        self.queue = AdmissionQueue(high_water, worker=self.worker)
        self.warmer = CacheWarmer(self.store, self.dv, n_hot,
                                  self.metrics,
                                  interval_s=warm_interval_s)
        self.n_hot = int(n_hot)
        self._table = torch.from_numpy(
            self.dv.table[self.worker]).to(self.device)
        self._base = self.worker * self.dv.n_per
        self._empty_cache_ids = np.full(self.n_hot, CACHE_PAD, np.int32)
        self._empty_cache_feats = np.zeros((self.n_hot, self.store.d),
                                           np.float32)

        expect_key = (cfg, max_batch_requests, self.collator.m_max,
                      self.collator.batch_size, self.store.d, self._base,
                      self.device)
        if program is not None and program.key != expect_key:
            raise ValueError(
                f"shared ServeProgram key {program.key} does not match "
                f"this service's static shape {expect_key}")
        self.program = program if program is not None else ServeProgram(
            cfg, max_batch_requests, self.collator.m_max,
            self.collator.batch_size, self.store.d, self._base, self.device)

        self._lock = threading.Lock()         # stats + lifecycle
        self._stats = {"served_fresh": 0, "served_stale": 0,
                       "served_uncached": 0, "deadline_miss": 0,
                       "errors": 0, "completed": 0, "micro_batches": 0}
        self._err_lock = threading.Lock()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def _run_program(self, mb: MicroBatch, cache_ids: np.ndarray,
                     cache_feats: np.ndarray, query: np.ndarray,
                     pulled: np.ndarray) -> np.ndarray:
        return self.program(self.params, self._table, cache_ids,
                            cache_feats, query, pulled, mb.edge_src,
                            mb.edge_dst, mb.edge_mask)

    @property
    def trace_count(self) -> int:
        return self.program.trace_count

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, seeds: np.ndarray,
               timeout_s: Optional[float] = None) -> PendingResponse:
        """Admit one request (typed ``Overloaded``/``ServeClosed`` on
        rejection); the response resolves via the returned future."""
        if self._closed:
            raise ServeClosed("submit after close()")
        return self.queue.submit(
            seeds, timeout_s if timeout_s is not None
            else self.default_timeout_s)

    # ------------------------------------------------------------------
    # serving step (synchronous core; the dispatcher thread loops it)
    # ------------------------------------------------------------------
    def step(self, timeout: Optional[float] = None) -> int:
        """Serve one micro-batch; -> number of requests resolved (with a
        response OR a typed per-request error). 0 if nothing arrived."""
        pairs = self.queue.pop_batch(self.collator.max_requests,
                                     timeout=timeout)
        if not pairs:
            return 0
        reqs = [p[0] for p in pairs]
        pendings = [p[1] for p in pairs]
        try:
            mb = self.collator.collate_micro_batch(reqs)
            snap, healthy = self.warmer.snapshot()
            if snap is None:
                tier = TIER_UNCACHED
                cache_ids, cache_feats = (self._empty_cache_ids,
                                          self._empty_cache_feats)
            else:
                tier = TIER_FRESH if healthy else TIER_STALE
                cache_ids, cache_feats = snap.dev_ids, snap.dev_feats
            query, pulled, slot_errors = self._assemble_host(
                mb, reqs, snap)
            logits = self._run_program(mb, cache_ids, cache_feats, query,
                                       pulled)
        except BaseException as exc:
            for pending in pendings:          # never strand a future
                pending.fail(exc)
            raise
        now = time.monotonic()
        for r, (req, pending) in enumerate(zip(reqs, pendings)):
            if r in slot_errors:
                pending.fail(slot_errors[r])
                with self._lock:
                    self._stats["errors"] += 1
                continue
            missed = now > req.deadline
            pending.fulfill(InferenceResponse(
                rid=req.rid,
                logits=logits[r, :req.seeds.shape[0]].copy(),
                tier=tier, stale=tier == TIER_STALE,
                deadline_missed=missed,
                cache_generation=snap.generation if snap else -1,
                served_cache=snap.cache if snap else None,
                latency_s=now - req.submitted_at))
            with self._lock:
                self._stats["completed"] += 1
                self._stats[f"served_{tier}"] += 1
                if missed:
                    self._stats["deadline_miss"] += 1
        with self._lock:
            self._stats["micro_batches"] += 1
        return len(reqs)

    def _assemble_host(self, mb: MicroBatch, reqs: List[InferenceRequest],
                       snap: Optional[WarmSnapshot]
                       ) -> Tuple[np.ndarray, np.ndarray,
                                  Dict[int, BaseException]]:
        """Host half of assembly: device-id query, residual pulls into
        the (R, m_max, d) buffer, traffic observation. Mirrors the
        kernel's priority exactly: local and cache-hit slots are left to
        the kernel; only true misses are pulled."""
        R = len(mb.collated)
        m_max = self.collator.m_max
        query = np.full((R, m_max), -1, np.int32)
        pulled = np.zeros((R, m_max, self.store.d), np.float32)
        slot_errors: Dict[int, BaseException] = {}
        traffic: List[np.ndarray] = []
        for r, req in enumerate(reqs):
            ids = mb.input_nodes[r]
            mask = mb.input_mask[r]
            safe = np.where(mask, ids, 0)
            dev = self.dv.g2d[safe]
            query[r] = np.where(mask, dev, -1).astype(np.int32)
            remote = mask & (dev // self.dv.n_per != self.worker)
            rem_idx = np.flatnonzero(remote)
            if rem_idx.shape[0] == 0:
                continue
            rem_gids = ids[rem_idx]
            traffic.append(rem_gids)
            if snap is not None and snap.cache.ids.shape[0] > 0:
                _, hit = snap.cache.lookup(rem_gids)
                miss_idx = rem_idx[~hit]
            else:
                miss_idx = rem_idx
            if miss_idx.shape[0] == 0:
                continue
            miss_gids = ids[miss_idx]
            # deadline pressure drops the retry budget: exponential
            # backoff on a nearly-expired request only converts a
            # typed failure into a deadline miss
            retries = (0 if req.remaining < self.pressure_slack_s
                       else self.store.pull_retries)
            gen = snap.generation if snap else -1

            def _pull(a: int, _gids=miss_gids, _rid=req.rid,
                      _gen=gen) -> np.ndarray:
                fault_point("serve_pull", attempt=a, epoch=_gen,
                            worker=self.worker, index=_rid)
                return self.store.sync_pull(_gids, self.metrics,
                                            critical_path=True)
            def _count_retry(_a: int) -> None:
                with self.store._m_lock:
                    self.metrics.pull_retries += 1
            try:
                pulled[r, miss_idx] = retry_call(
                    _pull, retries, self.store.retry_base_s,
                    on_retry=_count_retry)
            except InjectedFault as exc:
                slot_errors[r] = ServePullError(
                    f"request {req.rid}: residual pull of "
                    f"{miss_gids.shape[0]} rows failed past "
                    f"{retries} retries")
                slot_errors[r].__cause__ = exc
        if traffic:
            self.warmer.observe(np.concatenate(traffic))
        return query, pulled, slot_errors

    # ------------------------------------------------------------------
    # clean single-request oracle (differential reference)
    # ------------------------------------------------------------------
    def oracle(self, seeds: np.ndarray, rid: int) -> np.ndarray:
        """Bit-equality reference: the same rid-keyed sampling and the
        same program at the same static shapes, but
        features read STRAIGHT from the authoritative table with no
        cache, no store accounting and no fault probes."""
        req = InferenceRequest(
            rid=rid, seeds=np.asarray(seeds, dtype=np.int64),
            deadline=float("inf"), submitted_at=0.0)
        mb = self.collator.collate_micro_batch([req])
        R = len(mb.collated)
        m_max = self.collator.m_max
        query = np.full((R, m_max), -1, np.int32)
        pulled = np.zeros((R, m_max, self.store.d), np.float32)
        ids, mask = mb.input_nodes[0], mb.input_mask[0]
        safe = np.where(mask, ids, 0)
        query[0] = np.where(mask, self.dv.g2d[safe], -1).astype(np.int32)
        pulled[0, mask] = self.store.feat[ids[mask]]
        logits = self._run_program(mb, self._empty_cache_ids,
                                   self._empty_cache_feats, query, pulled)
        return logits[0, :req.seeds.shape[0]].copy()

    # ------------------------------------------------------------------
    # lifecycle + health
    # ------------------------------------------------------------------
    def start(self) -> "GNNInferenceService":
        """Launch warmer + dispatcher threads (online mode; tests may
        instead drive ``step()``/``warm_now()`` synchronously)."""
        self.warmer.start()
        self._thread = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name=f"serve-dispatch-w{self.worker}")
        self._thread.start()
        return self

    def _dispatch_loop(self) -> None:
        try:
            while not self._stop.is_set():
                self.step(timeout=0.02)
        except BaseException as exc:          # surfaced at close()
            with self._err_lock:
                self._err = exc

    def health(self) -> Dict[str, Any]:
        """One consistent snapshot of the serving counters + degraded
        state; what an operator (and the chaos harness) reads."""
        with self._lock:
            stats = dict(self._stats)
        _, healthy = self.warmer.snapshot()
        stats.update(
            shed=self.queue.shed,
            queue_depth=self.queue.depth(),
            warm_generation=self.warmer.generation,
            warm_failures=self.warmer.warm_failures,
            warmer_healthy=healthy,
            trace_count=self.trace_count,
            pull_retries=self.metrics.pull_retries,
            remote_bytes=self.metrics.remote_bytes,
            rpc_count=self.metrics.rpc_count)
        return stats

    def pending_error(self) -> Optional[BaseException]:
        with self._err_lock:
            err, self._err = self._err, None
        return err

    def close(self, timeout: float = 5.0) -> None:
        """Idempotent teardown: stop dispatch, fail the backlog typed,
        deadline-bounded joins naming any stuck thread."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread is not None and self._thread.ident is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"dispatcher thread {self._thread.name} still alive "
                    f"after {timeout}s join deadline")
        for _req, pending in self.queue.close():
            pending.fail(ServeClosed("service closed before dispatch"))
        self.warmer.close(timeout=timeout)
