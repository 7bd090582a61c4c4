"""The port's counterpart of ``make_mesh(shape, axes)`` and ``dp_axes``.

The JAX package runs its device-distributed epoch on a mesh of P
devices, one per RapidGNN worker, and on the CPU emulates those devices
inside one process. The port's ``Mesh`` is the same idea on one card:
P workers held in one process on one device, their shards, caches and
batches stacked on a leading worker dimension, and the all-to-all legs
of the exchange written as transpositions of that dimension
(``feature_a2a.pull_features``). Three layouts exist, as in the
reference: the flat ``(P,)`` over ``("data",)``, the hierarchical
``(H, D)`` over ``("dcn", "data")`` -- H emulated hosts of D workers,
flat worker ordinal ``h * D + i`` (``dist.topology``) -- and the
transformer's ``(dp, tp)`` over ``("data", "model")``: dp token groups,
each over tp model shards, which hold a slice of the decode KV cache's
sequence (``serve.attention``) and of the experts
(``models.transformer.moe``), as slices of one device's tensors. A
``(dp, 1)`` model mesh is the flat ``(dp,)``. The production meshes of
the dry-run (``launch.mesh.make_production_mesh``: ``(16, 16)`` over
``("data", "model")`` and ``(2, 16, 16)`` over ``("pod", "data",
"model")``, ``pod`` the outer data axis) are shape-only meshes on the
``meta`` device, built directly, not by ``make_mesh``: nothing runs on
them but a shape-only trace. A process group per card
(``feature_a2a.pull_shard``, ``serve.attention.sharded_decode_shard``,
``moe.moe_shard``) is the form for a machine with several cards.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

_LAYOUTS = (("data",), ("dcn", "data"), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P in-process workers on one device, split over ``hosts`` emulated
    hosts (1 on the flat mesh), each over ``model`` shards (1 but on the
    ``("data", "model")`` mesh); ``pods`` > 1 only on the shape-only
    multi-pod production mesh, whose P data workers are ``pods`` pods of
    P / pods."""
    num_workers: int
    device: torch.device
    hosts: int = 1
    model: int = 1
    pods: int = 1

    @property
    def devices_per_host(self) -> int:
        return self.num_workers // self.hosts

    @property
    def axis_names(self) -> Tuple[str, ...]:
        if self.pods > 1:
            return ("pod", "data", "model")
        if self.model > 1:
            return ("data", "model")
        return ("dcn", "data") if self.hosts > 1 else ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as the reference's ``mesh.shape``."""
        sizes = {"pod": self.pods, "dcn": self.hosts,
                 "data": self.devices_per_host // self.pods,
                 "model": self.model}
        return {a: sizes[a] for a in self.axis_names}

    @property
    def size(self) -> int:
        """Devices of the mesh: the product of its axis sizes."""
        return self.num_workers * self.model


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data",),
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``make_mesh((4,), ("data",))``: 4 workers on ``device`` (``None``
    means ``cuda``; raises without a card). ``make_mesh((2, 2), ("dcn",
    "data"))``: 2 hosts of 2 workers. ``make_mesh((2, 2), ("data",
    "model"))``: 2 token groups of 2 model shards."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if axes not in _LAYOUTS or len(shape) != len(axes):
        raise NotImplementedError(
            f"mesh {shape} over {axes}: the port has the flat (P,) over "
            f"('data',), the hierarchical (H, D) over ('dcn', 'data') and "
            f"the (dp, tp) over ('data', 'model')")
    if min(shape) < 1:
        raise ValueError(f"a mesh needs at least one worker, got {shape}")
    size = dict(zip(axes, shape))
    hosts = size.get("dcn", 1)
    return Mesh(num_workers=hosts * size["data"],
                device=resolve_device(device), hosts=hosts,
                model=size.get("model", 1))


def dp_axes(mesh) -> Optional[Tuple[str, ...]]:
    """The data-parallel axes of ``mesh``, outermost first (``pod``,
    ``dcn``, ``data``), or None when it has none of them."""
    axes = tuple(a for a in ("pod", "dcn", "data") if a in mesh.axis_names)
    return axes if axes else None
