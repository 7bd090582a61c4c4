"""Public wrapper of the ``gather_agg`` kernel (forward only).

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py:47``:
the fan-out-regular, dst-major masked mean ``h (m, d)``,
``edge_src/edge_mask (nd*fanout,)`` -> ``(nd, d)``, the sum of the
``fanout`` rows divided by ``max(count, 1)``. Bound on the card: bytes,
the distinct source rows the unmasked edges reference, read once, plus
the (nd, d) output. The design reads rows as coalesced column streams,
skips masked edges' rows and sums in order with no atomics, so the
result is deterministic.

CPU tensors (or ``interpret=True``) take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise. The backward (a
scatter-add over ``edge_src``) comes with the training path; until then
asking for a gradient raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.gather_agg.gather_agg import launch_gather_agg
from repro_torch.kernels.gather_agg.ref import gather_agg_ref

LAUNCHES = LaunchCount("gather_agg")


def gather_agg(h: torch.Tensor, edge_src: torch.Tensor,
               edge_mask: torch.Tensor, *, nd: int, fanout: int,
               interpret: bool = False) -> torch.Tensor:
    """h (m, d) float32; edge_src (nd*fanout,) int32 rows of ``h``;
    edge_mask (nd*fanout,) bool -> (nd, d) masked neighbour mean."""
    expect(h, "h", torch.float32, 2)
    expect(edge_src, "edge_src", torch.int32, 1)
    expect(edge_mask, "edge_mask", torch.bool, 1)
    if fanout < 1 or edge_src.shape[0] != nd * fanout \
            or edge_mask.shape[0] != nd * fanout:
        raise ValueError(f"edge lists of {edge_src.shape[0]}/"
                         f"{edge_mask.shape[0]} entries are not "
                         f"nd*fanout = {nd}*{fanout}")
    if h.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "gather_agg has no backward yet; call it under torch.no_grad() "
            "or torch.inference_mode()")
    if use_plain(interpret, h, edge_src, edge_mask):
        return gather_agg_ref(h, edge_src, edge_mask, nd, fanout)
    out = torch.empty((nd, h.shape[1]), dtype=torch.float32, device=h.device)
    if nd == 0 or h.shape[1] == 0:
        return out
    launch_gather_agg(h, edge_src, edge_mask, nd, fanout, out)
    LAUNCHES.bump()
    return out
