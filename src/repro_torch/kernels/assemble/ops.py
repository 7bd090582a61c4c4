"""Public wrapper of the fused feature assembly.

Replaces the TPU path ``repro/kernels/assemble/assemble.py``
(``classify`` over the ``search`` kernel, then ``_select_kernel``). On
CUDA tensors the fused backend launches one hand-written kernel
(``csrc/assemble.cu``): a warp per output row ranks the row's query over
the sorted hot-set ids with a warp-cooperative 32-ary search, does the
classify arithmetic inline and copies the row once from its winning
source. Bound on the card: bytes, one (m, d) read of the winning rows
plus one (m, d) write, the queries and the ids once
(``2*m*d*4 + m*4 + n_hot*4``); the design touches no losing row and
writes no rank. CPU tensors (or ``interpret=True``) take the plain
version, ``assemble_ref``; CUDA tensors never fall back.

Backends, bit-identical on the same inputs (every output row is a copy
of exactly one source row):

  * ``"fused"``  -- the one kernel above.
  * ``"ref"``    -- the plain where-chain oracle.
  * ``"staged"`` -- the reference's legacy three-stage chain: the C_s
    merge (``cache_lookup``: the ``search`` and ``merge_gather`` kernels
    on CUDA tensors) over the pulled rows, then ``local_merge``, the
    plain PyTorch overlay of this worker's shard (the reference's
    overlay is plain jnp, not a Pallas kernel).
  * ``"auto"``   -- ``"fused"`` on CUDA tensors, ``"ref"`` on the CPU.

``cache_ids=None`` (or an empty cache) assembles cache-less: local shard
over pulled residuals only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.assemble.assemble import launch_assemble
from repro_torch.kernels.assemble.ref import assemble_ref
from repro_torch.kernels.cache_lookup.ops import cache_lookup

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


def _fused(table, base, cache_ids, cache_feats, query, pulled, interpret):
    """The fused kernel on CUDA tensors, its plain version on the CPU."""
    for t, name in ((table, "table"), (cache_feats, "cache_feats"),
                    (pulled, "pulled")):
        expect(t, name, torch.float32, 2)
    expect(cache_ids, "cache_ids", torch.int32, 1)
    expect(query, "query", torch.int32, 1)
    m, d = pulled.shape
    if table.shape[1] != d or cache_feats.shape[1] != d:
        raise ValueError(f"feature widths differ: table {table.shape[1]}, "
                         f"cache {cache_feats.shape[1]}, pulled {d}")
    if query.shape[0] != m or cache_ids.shape[0] != cache_feats.shape[0]:
        raise ValueError("query/pulled or cache_ids/cache_feats row counts "
                         "differ")
    if table.shape[0] == 0:
        raise ValueError("assembly needs a non-empty shard table")
    if use_plain(interpret, table, cache_ids, cache_feats, query, pulled):
        return assemble_ref(table, base, cache_ids, cache_feats, query,
                            pulled)
    out = torch.empty((m, d), dtype=torch.float32, device=pulled.device)
    if m == 0 or d == 0:
        return out
    launch_assemble(table, base, cache_ids, cache_feats, pulled, query, out)
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
        # nothing can hit: empty stand-ins (an allocation, no fill kernel)
        cache_ids = query.new_empty((0,))
        cache_feats = pulled.new_empty((0, pulled.shape[1]))
    if backend == "ref":
        return assemble_ref(table, base, cache_ids, cache_feats, query,
                            pulled)
    return _fused(table, base, cache_ids, cache_feats, query, pulled,
                  interpret)
