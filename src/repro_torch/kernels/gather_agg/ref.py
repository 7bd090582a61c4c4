"""Plain PyTorch version of the ``gather_agg`` kernel.

Fan-out-regular layout (the deterministic sampler's invariant): edges are
dst-major, exactly ``fanout`` edges per dst node, so
``edge_src.reshape(nd, fanout)`` and no scatter is ever needed.

The sum runs over ``j = 0 .. fanout-1`` in order, starting from zero, as
the kernel and the TPU kernel it replaces sum; a masked edge adds +0.
So on finite inputs this version and the kernel agree bit for bit.

``gather_agg_bwd_ref`` is the backward, the JAX custom VJP's
``segment_sum`` as one ``index_add_`` of the scaled messages over
``edge_src``; on the CPU it adds in edge order, as the backward kernel
sums each row.
"""
from __future__ import annotations

import torch


def gather_agg_ref(h: torch.Tensor, edge_src: torch.Tensor,
                   edge_mask: torch.Tensor, nd: int,
                   fanout: int) -> torch.Tensor:
    """h (m, d); edge_src/mask (nd*fanout,) dst-major -> (nd, d) mean."""
    src = edge_src.reshape(nd, fanout).long()
    msk = edge_mask.reshape(nd, fanout)
    acc = torch.zeros((nd, h.shape[1]), dtype=h.dtype, device=h.device)
    for j in range(fanout):
        acc = acc + torch.where(msk[:, j, None], h[src[:, j]], 0.0)
    cnt = msk.sum(dim=1).to(h.dtype).clamp(min=1.0)
    return acc / cnt[:, None]


def gather_agg_bwd_ref(g: torch.Tensor, edge_src: torch.Tensor,
                       edge_mask: torch.Tensor, m: int, nd: int,
                       fanout: int) -> torch.Tensor:
    """g (nd, d) -> dh (m, d): ``dh[src_e] += g[e // fanout] * mask_e /
    max(cnt[e // fanout], 1)`` over every edge e."""
    msk = edge_mask.reshape(nd, fanout)
    cnt = msk.sum(dim=1).to(g.dtype).clamp(min=1.0)
    ge = (g / cnt[:, None])[:, None, :].expand(nd, fanout, g.shape[1]) \
        .reshape(nd * fanout, g.shape[1])
    msg = ge * edge_mask[:, None].to(g.dtype)
    return torch.zeros((m, g.shape[1]), dtype=g.dtype,
                       device=g.device).index_add_(0, edge_src.long(), msg)
