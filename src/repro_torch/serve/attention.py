"""Sequence-sharded decode attention over the ``model`` mesh axis: the
port's ``repro/serve/attention.py``.

The KV cache is sharded on its sequence dimension: model shard r holds
cache slots ``[r * S/tp, (r + 1) * S/tp)`` and runs the ``flash_decode``
partials (acc, m, l) over its slice, with ``clip(length - r * S/tp, 0,
S/tp)`` valid slots; the partials are combined in float32 -- ``m_g`` the
max over the shards, ``w = exp(m - m_g)``, ``acc_g = sum acc * w``,
``l_g = sum l * w`` -- and normalised. A shard with no valid slot gives
m = -1e30, l = 0, acc = 0, so its weight is 0. Two forms:

- ``sharded_decode_attention(mesh, ...)``: the tp shards of an
  in-process ``("data", "model")`` mesh are slices of one device's
  cache, folded into the batch (``(B, S) -> (B * tp, S / tp)`` is a
  view), so the whole batch is ONE kernel launch; the combine sums the
  shards in order 0..tp-1. The data groups of the mesh split the batch
  rows, which are independent, so they need no grouping here.
- ``sharded_decode_shard(...)``: one rank's body over a
  ``torch.distributed`` group of tp ranks, each holding its slice: one
  launch, one ``all_reduce(MAX)`` of m and one ``all_reduce(SUM)`` of
  the weighted acc and l packed into one buffer. Every term of the
  combine is computed as in the in-process form (the rank's launch is
  planned for the folded batch B * tp, so each row is summed in the
  folded launch's order), so with two ranks the two forms agree bit for
  bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.kernels.flash_decode.ops import flash_decode_partials
from repro_torch.kernels.flash_decode.ref import finalize


def _shard_len(S: int, tp: int) -> int:
    if tp < 1 or S % tp:
        raise ValueError(f"a cache of {S} slots does not split over {tp} "
                         f"model shards")
    return S // tp


def _weighted(acc, m, l, m_g):
    """One shard's terms of the combine: (acc * w, l * w)."""
    w = torch.exp(m - m_g)
    return acc * w[..., None], l * w


def sharded_decode_attention(mesh, q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, length: torch.Tensor, *,
                             attn_softcap: float = 0.0,
                             scale: Optional[float] = None,
                             interpret: bool = False) -> torch.Tensor:
    """q (B,1,H,dh); caches (B,S,kvH,dh) sequence-sharded over the mesh's
    ``model`` axis; length (B,) int32 -> (B,1,H,dh) in q's dtype.
    ``interpret``: the partials' plain version on any device, as the
    kernel's own wrappers take it."""
    tp = mesh.shape.get("model", 1)
    B, S, H = k_cache.shape[0], k_cache.shape[1], q.shape[2]
    s_local = _shard_len(S, tp)
    rest = k_cache.shape[2:]
    base = torch.arange(tp, dtype=torch.int32, device=length.device) \
        * s_local
    ln = (length.reshape(B, 1) - base[None, :]).clamp(0, s_local)
    acc, m, l = flash_decode_partials(
        q[:, 0].repeat_interleave(tp, dim=0),
        k_cache.reshape(B * tp, s_local, *rest),
        v_cache.reshape(B * tp, s_local, *rest),
        ln.reshape(B * tp).to(torch.int32), scale=scale,
        softcap=attn_softcap, interpret=interpret)
    # shard-major, so shard r's terms have the shapes of a rank's own
    acc = acc.reshape(B, tp, H, -1).transpose(0, 1).contiguous()
    m = m.reshape(B, tp, H).transpose(0, 1).contiguous()
    l = l.reshape(B, tp, H).transpose(0, 1).contiguous()
    m_g = m.amax(dim=0)
    acc_g = l_g = None
    for r in range(tp):
        a, b = _weighted(acc[r], m[r], l[r], m_g)
        acc_g, l_g = (a, b) if r == 0 else (acc_g + a, l_g + b)
    return finalize(acc_g, l_g)[:, None].to(q.dtype)


def sharded_decode_shard(q: torch.Tensor, k_local: torch.Tensor,
                         v_local: torch.Tensor, length: torch.Tensor, *,
                         rank: int, tp: int, group=None,
                         attn_softcap: float = 0.0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Model rank ``rank`` of ``tp`` in ``group`` (default the world):
    q (B,1,H,dh); this rank's cache slice k/v_local (B, S/tp, kvH, dh),
    slots ``[rank * S/tp, (rank + 1) * S/tp)``; length (B,) int32 over
    the whole cache -> (B,1,H,dh) in q's dtype, the same on every
    rank."""
    if not 0 <= rank < tp or dist.get_world_size(group) != tp:
        raise ValueError(f"model rank {rank} of {tp} in a group of "
                         f"{dist.get_world_size(group)}")
    B, s_local, H = k_local.shape[0], k_local.shape[1], q.shape[2]
    ln = (length - rank * s_local).clamp(0, s_local).to(torch.int32)
    acc, m, l = flash_decode_partials(q[:, 0].contiguous(), k_local,
                                      v_local, ln, scale=scale,
                                      softcap=attn_softcap,
                                      plan_batch=B * tp)
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    a, b = _weighted(acc, m, l, m_g)
    buf = torch.cat([a.reshape(B, -1), b], dim=1)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    acc_g, l_g = buf[:, :-H].reshape(a.shape), buf[:, -H:]
    return finalize(acc_g, l_g)[:, None].to(q.dtype)


__all__ = ["sharded_decode_attention", "sharded_decode_shard"]
