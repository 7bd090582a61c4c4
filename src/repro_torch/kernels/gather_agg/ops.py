"""Public wrappers of the ``gather_agg`` kernels, forward and backward.

Replaces the TPU kernel ``repro/kernels/gather_agg/gather_agg.py:47``:
the fan-out-regular, dst-major masked mean ``h (m, d)``,
``edge_src/edge_mask (nd*fanout,)`` -> ``(nd, d)``, the sum of the
``fanout`` rows divided by ``max(count, 1)``. Bound on the card: bytes,
the distinct source rows the unmasked edges reference, read once, plus
the (nd, d) output and the edge lists. One launch: a warp owns a dst row
(or a slice of its columns where the rows alone leave the card
under-filled), loads its edge ids and mask bytes once, and sums the
unmasked edges' rows as float4/float2/float vectors in edge order from
+0, several edges' row loads in flight ahead of their adds, with no
atomics, so the result is deterministic and bit-equal to ``ref.py``.

``gather_agg`` is differentiable in ``h``, as the JAX kernel's custom
VJP (``repro/kernels/gather_agg/ops.py:27``) makes it: the backward is
``gather_agg_bwd``, the scatter-add of ``g / max(count, 1)`` over
``edge_src``, done as a by-source order and an ordered per-row gather,
so it is deterministic too: two launches at every size (a counting sort
spread over thread block clusters, then the row sums over the card).
The edge operands carry no gradient, and no backward runs when ``h``
needs none (the input features of layer 0).

CPU tensors (or ``interpret=True``) take the plain versions in
``ref.py``; CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.gather_agg.gather_agg import (
    launch_gather_agg, launch_gather_agg_bwd)
from repro_torch.kernels.gather_agg.ref import (gather_agg_bwd_ref,
                                                gather_agg_ref)

LAUNCHES = LaunchCount("gather_agg")
BWD_LAUNCHES = LaunchCount("gather_agg_bwd")


def _check_edges(edge_src: torch.Tensor, edge_mask: torch.Tensor, nd: int,
                 fanout: int) -> None:
    expect(edge_src, "edge_src", torch.int32, 1)
    expect(edge_mask, "edge_mask", torch.bool, 1)
    if fanout < 1 or edge_src.shape[0] != nd * fanout \
            or edge_mask.shape[0] != nd * fanout:
        raise ValueError(f"edge lists of {edge_src.shape[0]}/"
                         f"{edge_mask.shape[0]} entries are not "
                         f"nd*fanout = {nd}*{fanout}")


def _forward(h, edge_src, edge_mask, nd, fanout, interpret):
    if use_plain(interpret, h, edge_src, edge_mask):
        return gather_agg_ref(h, edge_src, edge_mask, nd, fanout)
    out = torch.empty((nd, h.shape[1]), dtype=torch.float32, device=h.device)
    if nd == 0 or h.shape[1] == 0:
        return out
    launch_gather_agg(h, edge_src, edge_mask, nd, fanout, out)
    LAUNCHES.bump()
    return out


def gather_agg_bwd(g: torch.Tensor, edge_src: torch.Tensor,
                   edge_mask: torch.Tensor, *, m: int, nd: int, fanout: int,
                   interpret: bool = False) -> torch.Tensor:
    """g (nd, d) float32, the gradient of the (nd, d) mean -> dh (m, d):
    ``dh[src_e] += g[e // fanout] / max(cnt[e // fanout], 1)`` over the
    unmasked edges e, each row summed in ascending edge order."""
    expect(g, "g", torch.float32, 2)
    _check_edges(edge_src, edge_mask, nd, fanout)
    if g.shape[0] != nd:
        raise ValueError(f"g has {g.shape[0]} rows for nd = {nd}")
    if use_plain(interpret, g, edge_src, edge_mask):
        return gather_agg_bwd_ref(g, edge_src, edge_mask, m, nd, fanout)
    dh = torch.empty((m, g.shape[1]), dtype=torch.float32, device=g.device)
    if m == 0 or g.shape[1] == 0:
        return dh
    if nd >= 2 ** 24 or edge_src.shape[0] >= 2 ** 31:
        raise ValueError(f"gather_agg_bwd kernel takes fewer than 2^24 dst "
                         f"rows and 2^31 edges, got nd = {nd}, "
                         f"{edge_src.shape[0]} edges")
    launch_gather_agg_bwd(g, edge_src, edge_mask, nd, fanout, dh)
    BWD_LAUNCHES.bump()
    return dh


class _GatherAgg(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, edge_src, edge_mask, nd, fanout, interpret):
        ctx.save_for_backward(edge_src, edge_mask)
        ctx.shape = (h.shape[0], nd, fanout, interpret)
        return _forward(h, edge_src, edge_mask, nd, fanout, interpret)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        edge_src, edge_mask = ctx.saved_tensors
        m, nd, fanout, interpret = ctx.shape
        dh = gather_agg_bwd(g.contiguous(), edge_src, edge_mask, m=m, nd=nd,
                            fanout=fanout, interpret=interpret)
        return dh, None, None, None, None, None


def gather_agg(h: torch.Tensor, edge_src: torch.Tensor,
               edge_mask: torch.Tensor, *, nd: int, fanout: int,
               interpret: bool = False) -> torch.Tensor:
    """h (m, d) float32; edge_src (nd*fanout,) int32 rows of ``h``;
    edge_mask (nd*fanout,) bool -> (nd, d) masked neighbour mean,
    differentiable in ``h``."""
    expect(h, "h", torch.float32, 2)
    _check_edges(edge_src, edge_mask, nd, fanout)
    return _GatherAgg.apply(h, edge_src, edge_mask, nd, fanout, interpret)
