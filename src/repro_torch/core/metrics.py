"""Instrumentation: RPC/byte/hit counters, network-time model, energy model.

The paper measures on a 4-machine Chameleon testbed (10 Gbps Ethernet,
2x Xeon E5-2670v3, 2x P100) with NVML/psutil. We have no cluster, so:

  * communication is ACCOUNTED exactly (every pulled feature byte is
    counted at its source, padding charged to RapidGNN),
  * network TIME is modelled as  t = rtt * n_rpc + bytes / bandwidth
    with the testbed's 10 Gbps and a configurable RTT,
  * ENERGY is modelled as  E = P_mean * duration  per component, with
    P_mean taken from the paper's Table 3 measurements (CPU 36.73 W
    RapidGNN / 42.70 W baseline; GPU 30.84 / 29.45 W) -- durations are
    ours, power envelopes are the paper's. Reported as *modelled*.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List


@dataclasses.dataclass
class NetworkModel:
    """10 GbE + RPC-stack cost model (paper testbed, Table 1).

    t = rtt * n_rpc + bytes/BW + per_node_us * n_nodes

    The per-node term models (de)serialization + marshalling of feature
    RPCs -- the paper (§2.3) and P3 [13] attribute "up to 80 % of training
    time to communication AND SERIALIZATION"; a vectorized bulk pull
    (VectorPull) pays it only on its single batched request, which is
    exactly the asymmetry RapidGNN exploits."""
    bandwidth_gbps: float = 10.0
    rtt_ms: float = 0.5
    per_node_us: float = 2.0
    enabled: bool = True            # if True, fetches sleep for t_net

    def transfer_time(self, nbytes: int, n_rpc: int = 1,
                      n_nodes: int = 0) -> float:
        if n_rpc == 0 and nbytes == 0:
            return 0.0
        return (self.rtt_ms * 1e-3 * max(n_rpc, 1) +
                nbytes * 8.0 / (self.bandwidth_gbps * 1e9) +
                self.per_node_us * 1e-6 * n_nodes)

    def charge(self, nbytes: int, n_rpc: int = 1,
               n_nodes: int = 0) -> float:
        t = self.transfer_time(nbytes, n_rpc, n_nodes)
        if self.enabled and t > 0:
            time.sleep(t)
        return t


@dataclasses.dataclass
class EpochMetrics:
    """Per-epoch counters. Every field is a plain int/float so the whole
    record serializes losslessly through ``to_dict``/``from_dict`` (the
    campaign's ``CellResult`` export in the JAX package)."""
    epoch: int = 0
    rpc_count: int = 0               # paper's rpc_e: SyncPull calls' ids
    sync_pull_calls: int = 0
    remote_bytes: int = 0            # bytes pulled off-worker this epoch
    vector_pull_bytes: int = 0       # bulk cache-build bytes (off critical path)
    cache_hits: int = 0
    cache_misses: int = 0
    prefetch_hits: int = 0           # batches served from the prefetch queue
    default_path: int = 0            # trainer outran prefetcher (race)
    remote_requests: int = 0         # remote ids requested (pre-cache)
    wall_time_s: float = 0.0
    compute_time_s: float = 0.0
    fetch_stall_s: float = 0.0       # critical-path fetch time
    modeled_net_time_s: float = 0.0
    sync_net_time_s: float = 0.0     # SyncPull-only (per-step network time)
    # -- fault plane (DESIGN.md §10): recovery accounting ------------------
    pull_retries: int = 0            # transient sync_pull failures retried
    prefetch_retries: int = 0        # prefetch batches rebuilt after fault
    csec_degraded: int = 0           # C_sec build lost -> stale C_s kept

    @property
    def hit_rate(self) -> float:
        t = self.cache_hits + self.cache_misses
        return self.cache_hits / t if t else 0.0

    def to_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "EpochMetrics":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass
class RunMetrics:
    epochs: List[EpochMetrics] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready view: the per-epoch records plus the aggregate
        ``totals()`` (already derived, so consumers never re-sum)."""
        return {"epochs": [e.to_dict() for e in self.epochs],
                "totals": self.totals()}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "RunMetrics":
        return cls(epochs=[EpochMetrics.from_dict(e)
                           for e in d["epochs"]])

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for f in dataclasses.fields(EpochMetrics):
            if f.name == "epoch":
                continue
            out[f.name] = sum(getattr(e, f.name) for e in self.epochs)
        n = max(len(self.epochs), 1)
        out["mean_epoch_time_s"] = out["wall_time_s"] / n
        tot_hit = out["cache_hits"] + out["cache_misses"]
        out["hit_rate"] = out["cache_hits"] / tot_hit if tot_hit else 0.0
        return out


# ---- energy model ----------------------------------------------------------

#: component power envelopes (W). Calibrated to paper Table 3.
POWER = {
    "rapidgnn": {"cpu": 36.73, "gpu": 30.84},
    "baseline": {"cpu": 42.70, "gpu": 29.45},
}


def modelled_energy(duration_s: float, system: str) -> Dict[str, float]:
    p = POWER[system]
    return {"cpu_J": p["cpu"] * duration_s,
            "gpu_J": p["gpu"] * duration_s,
            "total_J": (p["cpu"] + p["gpu"]) * duration_s}
