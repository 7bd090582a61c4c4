"""Host-side core pieces of the serving slice: metrics, the hot-set
cache, the sharded feature store and the static-shape collation."""
from repro_torch.core.cache import FeatureCache, DoubleBufferCache
from repro_torch.core.fetch import ShardedFeatureStore
from repro_torch.core.metrics import (EpochMetrics, RunMetrics, NetworkModel,
                                      modelled_energy, POWER)
from repro_torch.core.schedule import CollatedBatch, collate, select_hot_set

__all__ = [
    "FeatureCache", "DoubleBufferCache", "ShardedFeatureStore",
    "EpochMetrics", "RunMetrics", "NetworkModel", "modelled_energy",
    "POWER", "CollatedBatch", "collate", "select_hot_set",
]
