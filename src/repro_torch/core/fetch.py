"""Distributed KV-store feature fetching: VectorPull / SyncPull.

Host-simulation path (this module): the sharded feature store is the
paper's per-worker KV store; every cross-partition read is accounted (and
optionally time-charged through the NetworkModel). A host-side copy of
the JAX package's ``repro.core.fetch``, kept bit-identical to it.

Paper mapping:
  VectorPull(ids)  -- one bulk vectorized request building the cache C_s
  SyncPull(ids)    -- residual-miss fetch; issued by the *prefetcher*, so
                      it is off the trainer's critical path unless the
                      trainer outruns the queue.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from repro_torch.core.metrics import EpochMetrics, NetworkModel
from repro_torch.fault.inject import fault_point, retry_call
from repro_torch.graph.partition import PartitionedGraph


class ShardedFeatureStore:
    """Paper's Distributed KV store: features owned per partition."""

    #: bounded retry budget for transient pull failures (fault plane,
    #: DESIGN.md §10): a SyncPull RPC that fails transiently is retried
    #: with exponential backoff; a persistent failure propagates typed.
    pull_retries = 2
    retry_base_s = 1e-3

    def __init__(self, pg: PartitionedGraph, worker: int,
                 net: Optional[NetworkModel] = None):
        self.pg = pg
        self.worker = worker
        self.net = net or NetworkModel(enabled=False)
        self.feat = pg.graph.features     # authoritative global table
        self.d = pg.graph.feat_dim
        self.itemsize = self.feat.itemsize
        # metrics accumulation is lock-guarded: the serving path issues
        # concurrent sync_pulls against ONE store, and `m.x += v` on a
        # dataclass attribute is a read-modify-write race that would
        # break the `bytes == sum(n_remote) * row` differential
        # identity. Callers sharing one EpochMetrics across *stores*
        # must still coordinate externally (the runners never do).
        self._m_lock = threading.Lock()

    def _remote_mask(self, ids: np.ndarray) -> np.ndarray:
        return self.pg.owner[ids] != self.worker

    # -- bulk cache build (one vectorized RPC; paper Alg. 1 line 4) --------
    def vector_pull(self, ids: np.ndarray, m: EpochMetrics) -> np.ndarray:
        nbytes = int(ids.shape[0]) * self.d * self.itemsize
        # ONE batched request: the per-node marshalling tax is paid once
        t = self.net.transfer_time(nbytes, n_rpc=1, n_nodes=1)
        with self._m_lock:
            m.vector_pull_bytes += nbytes
            m.modeled_net_time_s += t
        # bulk pull is off the critical path (built concurrently) -> no sleep
        return self.feat[ids].copy()

    # -- residual miss fetch (paper Alg. 1 line 14) -------------------------
    def sync_pull(self, ids: np.ndarray, m: EpochMetrics,
                  critical_path: bool = False) -> np.ndarray:
        # transient-failure probe BEFORE any accounting: a retried pull
        # must not inflate rpc_count/remote_bytes (the bytes_identity
        # differential check counts successful transfers only)
        def _on_retry(_a: int) -> None:
            with self._m_lock:
                m.pull_retries += 1
        retry_call(lambda a: fault_point("pull", attempt=a,
                                         epoch=m.epoch,
                                         worker=self.worker),
                   self.pull_retries, self.retry_base_s,
                   on_retry=_on_retry)
        remote = self._remote_mask(ids)
        n_remote = int(remote.sum())
        nbytes = n_remote * self.d * self.itemsize
        # one RPC per remote partition touched (DistDGL KV-store
        # fan-out); a fully-LOCAL batch touches no partition, so it
        # charges zero RPCs and zero modelled time (the historical
        # ``max(len(owners), 1)`` floor modelled a phantom RPC there)
        owners = np.unique(self.pg.owner[ids[remote]]) if n_remote else []
        n_rpc = len(owners)
        # the critical-path charge SLEEPS for t_net -- keep it outside
        # the metrics lock or one slow pull serializes every other caller
        t = (self.net.charge(nbytes, n_rpc=n_rpc, n_nodes=n_remote)
             if critical_path
             else self.net.transfer_time(nbytes, n_rpc=n_rpc,
                                         n_nodes=n_remote))
        with self._m_lock:
            m.rpc_count += n_remote      # paper's rpc_e += |M_i|
            m.sync_pull_calls += 1
            m.remote_bytes += nbytes
            m.modeled_net_time_s += t
            m.sync_net_time_s += t
        return self.feat[ids].copy()

    # -- local reads are free -----------------------------------------------
    def local_read(self, ids: np.ndarray) -> np.ndarray:
        return self.feat[ids].copy()
