"""Hierarchical multi-host topology for the RapidGNN device path, the
port of ``repro/dist/topology.py``.

The flat ``("data",)`` mesh treats every worker pair as equidistant, but
the paper's communication win matters most when workers sit across slow
inter-node links. ``Topology`` describes the machine praxis-style --
``ici_mesh_shape`` (fast intra-host interconnect), ``dcn_mesh_shape``
(slow cross-host data-center network) and ``mesh_axis_names`` -- and
carries the worker/host arithmetic every two-tier exchange in
``feature_a2a`` / ``gnn_step`` addresses.

Axis layout: the DCN axis is OUTER, so the flat worker ordinal of device
``(h, i)`` is ``h * devices_per_host + i`` -- the row-major order that
keeps the two-tier exchange bit-compatible with the flat one. A flat
topology (``hosts == 1``) degenerates to the ``("data",)`` mesh.

``owner_bias`` feeds the weighted ``select_hot_set`` path: hot-set cache
admission can up-weight features whose owners sit across the DCN
boundary (opt-in; the default schedule stays bit-identical to the
unbiased one).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Praxis-style hierarchical mesh description.

    ``ici_mesh_shape[i]`` and ``dcn_mesh_shape[i]`` give axis ``i`` of
    the physical mesh its intra-host (ICI) and cross-host (DCN) extents;
    the realised mesh axis extent is their product. The RapidGNN worker
    axes are ``data`` (ICI) and ``dcn`` (the DCN factor of the same
    logical axis, kept as a separate OUTER mesh axis so the exchange can
    address either tier).
    """
    ici_mesh_shape: Tuple[int, ...]
    dcn_mesh_shape: Tuple[int, ...]
    mesh_axis_names: Tuple[str, ...]

    def __post_init__(self):
        if not (len(self.ici_mesh_shape) == len(self.dcn_mesh_shape)
                == len(self.mesh_axis_names)):
            raise ValueError(
                f"mesh shape/name rank mismatch: ici "
                f"{self.ici_mesh_shape}, dcn {self.dcn_mesh_shape}, "
                f"names {self.mesh_axis_names}")
        if len(self.mesh_axis_names) != 1 or \
                self.mesh_axis_names[0] != "data":
            raise ValueError(
                f"only the single RapidGNN worker axis ('data',) is "
                f"supported, got {self.mesh_axis_names}")
        if min(self.ici_mesh_shape) < 1 or min(self.dcn_mesh_shape) < 1:
            raise ValueError(
                f"mesh extents must be >= 1: ici {self.ici_mesh_shape}, "
                f"dcn {self.dcn_mesh_shape}")

    # -- construction -----------------------------------------------------

    @staticmethod
    def flat(num_workers: int) -> "Topology":
        """Single-host topology: the classic ``("data",)`` mesh."""
        return Topology(ici_mesh_shape=(num_workers,),
                        dcn_mesh_shape=(1,), mesh_axis_names=("data",))

    @staticmethod
    def hierarchical(hosts: int, devices_per_host: int) -> "Topology":
        """``hosts`` emulated hosts x ``devices_per_host`` devices."""
        return Topology(ici_mesh_shape=(devices_per_host,),
                        dcn_mesh_shape=(hosts,), mesh_axis_names=("data",))

    @staticmethod
    def parse(s: str, num_workers: int) -> "Topology":
        """Cell string -> Topology: ``"flat"`` or ``"HxD"`` (e.g.
        ``"2x4"``), validated against the cell's worker count."""
        if s == "flat":
            return Topology.flat(num_workers)
        m = re.fullmatch(r"(\d+)x(\d+)", s)
        if m is None:
            raise ValueError(f"bad topology {s!r}: expected 'flat' or "
                             f"'<hosts>x<devices_per_host>'")
        hosts, dph = int(m.group(1)), int(m.group(2))
        if hosts * dph != num_workers:
            raise ValueError(f"topology {s!r} describes {hosts * dph} "
                             f"workers but the cell has {num_workers}")
        return Topology.hierarchical(hosts, dph)

    # -- derived geometry -------------------------------------------------

    @property
    def hosts(self) -> int:
        return int(math.prod(self.dcn_mesh_shape))

    @property
    def devices_per_host(self) -> int:
        return int(math.prod(self.ici_mesh_shape))

    @property
    def num_workers(self) -> int:
        return self.hosts * self.devices_per_host

    @property
    def is_hierarchical(self) -> bool:
        return self.hosts > 1

    @property
    def worker_axes(self) -> Union[str, Tuple[str, ...]]:
        """The axis name(s) addressing a flat worker id: ``"data"``
        flat, ``("dcn", "data")`` hierarchical (dcn outer = row-major
        flat ordinal ``h * devices_per_host + i``)."""
        return ("dcn", "data") if self.is_hierarchical else "data"

    def make_mesh(self, device=None):
        """The port's ``Mesh`` of this topology on one ``device``
        (``None`` means ``cuda``): ``(P,)`` over ``("data",)`` flat,
        ``(H, D)`` over ``("dcn", "data")`` hierarchical."""
        from repro_torch.dist.mesh import make_mesh
        if self.is_hierarchical:
            return make_mesh((self.hosts, self.devices_per_host),
                             ("dcn", "data"), device=device)
        return make_mesh((self.num_workers,), ("data",), device=device)

    # -- worker/host arithmetic -------------------------------------------

    def host_of(self, worker: Union[int, np.ndarray]):
        """Flat worker ordinal(s) -> host ordinal(s)."""
        return worker // self.devices_per_host

    def local_of(self, worker: Union[int, np.ndarray]):
        """Flat worker ordinal(s) -> intra-host device index."""
        return worker % self.devices_per_host

    def same_host(self, a, b):
        """Elementwise: do workers ``a`` and ``b`` share a host?"""
        return self.host_of(a) == self.host_of(b)

    def owner_bias(self, worker: int, dcn_bias: float) -> np.ndarray:
        """(P,) ``select_hot_set`` frequency multiplier for ``worker``:
        ``dcn_bias`` on owners across the DCN boundary, 1.0 on same-host
        owners -- cache admission then prefers saving the expensive
        cross-host fetches. ``dcn_bias=1.0`` is the unbiased schedule."""
        if dcn_bias <= 0:
            raise ValueError(f"dcn_bias must be positive, got {dcn_bias}")
        owners = np.arange(self.num_workers)
        return np.where(self.same_host(owners, worker), 1.0,
                        float(dcn_bias))

    def describe(self) -> str:
        if self.is_hierarchical:
            return f"{self.hosts}x{self.devices_per_host}"
        return "flat"
