"""The port's counterpart of ``make_mesh((P,), ("data",))``.

The JAX package runs its device-distributed epoch on a mesh of P
devices, one per RapidGNN worker, and on the CPU emulates those devices
inside one process. The port's ``Mesh`` is the same idea on one card:
P workers held in one process on one device, their shards, caches and
batches stacked on a leading worker dimension, and the all-to-all legs
of the exchange written as transpositions of that dimension
(``feature_a2a.pull_features``). Only the flat ``("data",)`` axis
exists; the hierarchical ``("dcn", "data")`` topology waits for ROADMAP
Queue 1 item 8, and a process group per card (``feature_a2a.pull_shard``)
for a machine with several cards.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """P in-process workers on one device."""
    num_workers: int
    device: torch.device


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data",),
              device: Optional[Union[str, torch.device]] = None) -> Mesh:
    """``make_mesh((4,), ("data",))``: 4 workers on ``device`` (``None``
    means ``cuda``; raises without a card)."""
    if tuple(axes) != ("data",) or len(tuple(shape)) != 1:
        raise NotImplementedError(
            f"mesh {tuple(shape)} over {tuple(axes)}: the port has only the "
            f"flat ('data',) worker axis; the hierarchical topology waits "
            f"for ROADMAP Queue 1 item 8")
    if int(shape[0]) < 1:
        raise ValueError(f"a mesh needs at least one worker, got {shape}")
    return Mesh(num_workers=int(shape[0]), device=resolve_device(device))
