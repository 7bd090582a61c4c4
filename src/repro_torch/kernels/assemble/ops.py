"""Public wrapper of the fused feature assembly.

Replaces the TPU path ``repro/kernels/assemble/assemble.py``
(``classify`` over the ``search`` kernel, then ``_select_kernel``). On
CUDA tensors the fused backend launches two hand-written kernels: the
``search`` kernel (``kernels/cache_lookup``) for (pos, hit), then the
select kernel, which does the classify arithmetic inline and copies
each row once from its winning source. Bound on the card: bytes, one
(m, d) read of the winning rows plus one (m, d) write; the design
touches no losing row. CPU tensors (or ``interpret=True``) take the
plain versions in ``ref.py``; CUDA tensors never fall back.

Backends, bit-identical on the same inputs (every output row is a copy
of exactly one source row):

  * ``"fused"``  -- ``search`` + select, as above.
  * ``"ref"``    -- the plain where-chain oracle.
  * ``"staged"`` -- the reference's legacy three-stage chain: the C_s
    merge (``cache_lookup``: the ``search`` and ``merge_gather`` kernels
    on CUDA tensors) over the pulled rows, then ``local_merge``, the
    plain PyTorch overlay of this worker's shard (the reference's
    overlay is plain jnp, not a Pallas kernel).
  * ``"auto"``   -- ``"fused"`` on CUDA tensors, ``"ref"`` on the CPU.

``cache_ids=None`` assembles cache-less: local shard over pulled
residuals only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.assemble.assemble import launch_select
from repro_torch.kernels.assemble.ref import assemble_ref, select_ref
from repro_torch.kernels.cache_lookup.ops import cache_lookup, search
from repro_torch.kernels.cache_lookup.ref import SENTINEL

BACKENDS = ("auto", "fused", "ref", "staged")

LAUNCHES = LaunchCount("assemble")


def resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"assemble backend {backend!r} not in {BACKENDS}")
    if backend == "auto":
        return "fused" if device.type == "cuda" else "ref"
    return backend


def local_merge(table: torch.Tensor, base: int, query: torch.Tensor,
                fallback: torch.Tensor) -> torch.Tensor:
    """Overlay this worker's shard rows onto ``fallback`` where the
    queried device id is locally owned (slot in [0, n_per)); padding ids
    (-1) are never local. The final stage of the staged chain."""
    n_per = table.shape[0]
    slot = query.long() - int(base)
    local = (slot >= 0) & (slot < n_per)
    rows = table[slot.clamp(0, n_per - 1)]
    return torch.where(local[:, None], rows.to(fallback.dtype), fallback)


def _staged(table, base, cache_ids, cache_feats, query, pulled,
            interpret):
    """pulled -> C_s merge -> local overlay: three (m, d)
    materializations, bit-identical to the single-pass backends."""
    if cache_ids is None:
        return local_merge(table, base, query, pulled)
    merged, _ = cache_lookup(cache_ids, cache_feats, query, pulled,
                             interpret=interpret)
    return local_merge(table, base, query, merged)


def select(table: torch.Tensor, base: int, cache_feats: torch.Tensor,
           query: torch.Tensor, pos: torch.Tensor, hit: torch.Tensor,
           pulled: torch.Tensor, *, interpret: bool = False
           ) -> torch.Tensor:
    """The select pass over ``search`` outputs: table (n_per, d);
    cache_feats (n_hot >= 1, d); query/pos (m,) int32; hit (m,) bool;
    pulled (m, d) -> (m, d)."""
    for t, name in ((table, "table"), (cache_feats, "cache_feats"),
                    (pulled, "pulled")):
        expect(t, name, torch.float32, 2)
    expect(query, "query", torch.int32, 1)
    expect(pos, "pos", torch.int32, 1)
    expect(hit, "hit", torch.bool, 1)
    m, d = pulled.shape
    if table.shape[1] != d or cache_feats.shape[1] != d:
        raise ValueError(f"feature widths differ: table {table.shape[1]}, "
                         f"cache {cache_feats.shape[1]}, pulled {d}")
    if not query.shape[0] == pos.shape[0] == hit.shape[0] == m:
        raise ValueError("query/pos/hit/pulled row counts differ")
    if table.shape[0] == 0 or cache_feats.shape[0] == 0:
        raise ValueError("select needs a non-empty table and cache "
                         "(an empty cache is one sentinel row)")
    if use_plain(interpret, table, cache_feats, query, pos, hit, pulled):
        return select_ref(table, base, cache_feats, query, pos, hit, pulled)
    out = torch.empty((m, d), dtype=torch.float32, device=pulled.device)
    if m == 0 or d == 0:
        return out
    launch_select(table, base, cache_feats, pulled, query, pos, hit, out)
    LAUNCHES.bump()
    return out


def assemble_features(table: torch.Tensor, base: int,
                      cache_ids: Optional[torch.Tensor],
                      cache_feats: Optional[torch.Tensor],
                      query: torch.Tensor, pulled: torch.Tensor, *,
                      backend: str = "auto",
                      interpret: bool = False) -> torch.Tensor:
    """Single-pass per-step feature assembly.

    table (n_per, d) this worker's shard; base first device slot;
    cache_ids (n_hot,) sorted int32 / None; cache_feats (n_hot, d) /
    None; query (m,) int32 device ids (-1 padded); pulled (m, d)
    residual buffer -> (m, d) assembled rows, priority local > C_s >
    pulled.
    """
    backend = resolve_backend(backend, pulled.device)
    if backend == "staged":
        return _staged(table, base, cache_ids, cache_feats, query, pulled,
                       interpret)
    if cache_ids is None or cache_ids.shape[0] == 0:
        # sentinel row: never hit, but keeps row 0 addressable
        cache_ids = torch.full((1,), SENTINEL, dtype=torch.int32,
                               device=query.device)
        cache_feats = torch.zeros((1, pulled.shape[1]), dtype=pulled.dtype,
                                  device=pulled.device)
    if backend == "ref":
        return assemble_ref(table, base, cache_ids, cache_feats, query,
                            pulled)
    pos, hit = search(cache_ids, query, interpret=interpret)
    return select(table, base, cache_feats, query, pos, hit, pulled,
                  interpret=interpret)
