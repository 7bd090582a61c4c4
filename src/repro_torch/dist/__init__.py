"""Device-distributed RapidGNN over a flat ``("data",)`` or hierarchical
``("dcn", "data")`` worker mesh (and the transformer's ``("data",
"model")`` mesh, ``make_mesh``/``dp_axes``): the device relabelling of the
partitioned graph, the offline pull plans (two-tier on a hierarchical
topology) and the epoch's collation on the device, the all-to-all cache-first feature exchange, the pipelined
and on-demand epoch programs, the multi-epoch runners and the dry-run's
placement specs (``shardings``) (the port of ``repro.dist``)."""
from repro_torch.dist.mesh import Mesh, dp_axes, make_mesh
from repro_torch.dist.topology import Topology
from repro_torch.dist.feature_a2a import (PullPlan, build_pull_plan,
                                          cache_gather, pack_pull_lanes,
                                          pack_pull_lanes_two_tier,
                                          pull_features,
                                          pull_features_two_tier,
                                          pull_shard, pull_shard_two_tier)
from repro_torch.dist.gnn_step import (CACHE_PAD, DeviceCache, DeviceView,
                                       collate_device_epoch,
                                       collate_device_epoch_loop,
                                       empty_caches, epoch_k_max,
                                       epoch_k_max_split,
                                       make_ondemand_epoch,
                                       make_pipelined_epoch, prefetch_stream,
                                       stack_caches)
from repro_torch.dist.device_collate import collate_epoch_on_device
from repro_torch.dist.runner import (DeviceBaselineRunner, DeviceEpochReport,
                                     DeviceRapidGNNRunner, StagingError,
                                     assert_host_parity, host_miss_matrix)
from repro_torch.dist.shardings import (Spec, batch_shardings,
                                        decode_state_shardings, fit_spec,
                                        opt_shardings, param_shardings)

__all__ = [
    "Mesh", "make_mesh", "dp_axes", "Topology",
    "PullPlan", "build_pull_plan", "pack_pull_lanes",
    "pack_pull_lanes_two_tier", "pull_shard", "pull_shard_two_tier",
    "pull_features", "pull_features_two_tier", "cache_gather",
    "CACHE_PAD", "DeviceCache", "DeviceView", "epoch_k_max",
    "epoch_k_max_split",
    "collate_device_epoch", "collate_device_epoch_loop", "stack_caches",
    "collate_epoch_on_device",
    "make_pipelined_epoch", "make_ondemand_epoch", "empty_caches",
    "prefetch_stream",
    "StagingError", "DeviceEpochReport", "DeviceRapidGNNRunner",
    "DeviceBaselineRunner", "host_miss_matrix", "assert_host_parity",
    "Spec", "fit_spec", "param_shardings", "opt_shardings",
    "batch_shardings", "decode_state_shardings",
]
