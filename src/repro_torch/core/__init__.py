"""Host-side core of the port: the deterministic schedule, the hot-set
cache, the sharded feature store, the prefetch pipeline and the host-sim
runners (copies of the JAX package's numpy modules)."""
from repro_torch.core.schedule import (build_schedule, WorkerSchedule,
                                       EpochSchedule, CollatedBatch, collate,
                                       epoch_edge_maxima, merge_pad_bounds,
                                       select_hot_set)
from repro_torch.core.cache import FeatureCache, DoubleBufferCache
from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.prefetch import (Prefetcher, SecondaryCacheBuilder,
                                       assemble_features)
from repro_torch.core.runtime import (RapidGNNRunner, BaselineRunner,
                                      global_pad_bounds)
from repro_torch.core.metrics import (EpochMetrics, RunMetrics, NetworkModel,
                                      modelled_energy, POWER)

__all__ = [
    "build_schedule", "WorkerSchedule", "EpochSchedule", "CollatedBatch",
    "collate", "epoch_edge_maxima", "merge_pad_bounds", "select_hot_set",
    "FeatureCache", "DoubleBufferCache", "ShardedFeatureStore",
    "Prefetcher", "SecondaryCacheBuilder", "assemble_features",
    "RapidGNNRunner", "BaselineRunner", "global_pad_bounds",
    "EpochMetrics", "RunMetrics", "NetworkModel", "modelled_energy",
    "POWER",
]
