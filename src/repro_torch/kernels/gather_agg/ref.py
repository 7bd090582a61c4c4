"""Plain PyTorch version of the ``gather_agg`` kernel.

Fan-out-regular layout (the deterministic sampler's invariant): edges are
dst-major, exactly ``fanout`` edges per dst node, so
``edge_src.reshape(nd, fanout)`` and no scatter is ever needed.

The sum runs over ``j = 0 .. fanout-1`` in order, starting from zero, as
the kernel and the TPU kernel it replaces sum; a masked edge adds +0.
So on finite inputs this version and the kernel agree bit for bit.
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
