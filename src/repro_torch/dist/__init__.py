"""Device relabelling of the partitioned graph (numpy, host side)."""
from repro_torch.dist.gnn_step import CACHE_PAD, DeviceCache, DeviceView

__all__ = ["CACHE_PAD", "DeviceCache", "DeviceView"]
