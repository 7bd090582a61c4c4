"""Device-distributed RapidGNN over a flat worker mesh: the device
relabelling of the partitioned graph, the offline pull plans, the
all-to-all cache-first feature exchange and the pipelined and
on-demand epoch programs (the port of ``repro.dist``, flat topology)."""
from repro_torch.dist.mesh import Mesh, make_mesh
from repro_torch.dist.feature_a2a import (PullPlan, build_pull_plan,
                                          cache_gather, pack_pull_lanes,
                                          pull_features, pull_shard)
from repro_torch.dist.gnn_step import (CACHE_PAD, DeviceCache, DeviceView,
                                       collate_device_epoch,
                                       collate_device_epoch_loop,
                                       empty_caches, epoch_k_max,
                                       make_ondemand_epoch,
                                       make_pipelined_epoch, prefetch_stream,
                                       stack_caches)
from repro_torch.dist.runner import host_miss_matrix

__all__ = [
    "Mesh", "make_mesh",
    "PullPlan", "build_pull_plan", "pack_pull_lanes", "pull_shard",
    "pull_features", "cache_gather",
    "CACHE_PAD", "DeviceCache", "DeviceView", "epoch_k_max",
    "collate_device_epoch", "collate_device_epoch_loop", "stack_caches",
    "make_pipelined_epoch", "make_ondemand_epoch", "empty_caches",
    "prefetch_stream",
    "host_miss_matrix",
]
