"""The port's counterpart of ``make_mesh(shape, axes)``.

The JAX package runs its device-distributed epoch on a mesh of P
devices, one per RapidGNN worker, and on the CPU emulates those devices
inside one process. The port's ``Mesh`` is the same idea on one card:
P workers held in one process on one device, their shards, caches and
batches stacked on a leading worker dimension, and the all-to-all legs
of the exchange written as transpositions of that dimension
(``feature_a2a.pull_features``). Two layouts exist, as in the
reference: the flat ``(P,)`` over ``("data",)``, and the hierarchical
``(H, D)`` over ``("dcn", "data")`` -- H emulated hosts of D workers,
flat worker ordinal ``h * D + i`` (``dist.topology``). A process group
per card (``feature_a2a.pull_shard``) is the form for a machine with
several cards.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

_LAYOUTS = {1: ("data",), 2: ("dcn", "data")}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P in-process workers on one device, split over ``hosts`` emulated
    hosts (1 on the flat mesh)."""
    num_workers: int
    device: torch.device
    hosts: int = 1

    @property
    def devices_per_host(self) -> int:
        return self.num_workers // self.hosts

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("dcn", "data") if self.hosts > 1 else ("data",)


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data",),
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``make_mesh((4,), ("data",))``: 4 workers on ``device`` (``None``
    means ``cuda``; raises without a card). ``make_mesh((2, 2), ("dcn",
    "data"))``: 2 hosts of 2 workers."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if _LAYOUTS.get(len(shape)) != axes:
        raise NotImplementedError(
            f"mesh {shape} over {axes}: the port has the flat (P,) over "
            f"('data',) and the hierarchical (H, D) over ('dcn', 'data')")
    if min(shape) < 1:
        raise ValueError(f"a mesh needs at least one worker, got {shape}")
    hosts = shape[0] if len(shape) == 2 else 1
    n = hosts * shape[-1]
    return Mesh(num_workers=n, device=resolve_device(device),
                hosts=hosts)
