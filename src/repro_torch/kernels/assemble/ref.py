"""Plain PyTorch versions of the feature assembly.

Semantics of one assembled row (priority order, as the JAX package's
``repro/kernels/assemble/ref.py``):

  1. LOCAL   -- the queried device id falls in this worker's shard
                (``base <= q < base + n_per``): serve ``table[q - base]``.
  2. CACHED  -- the id binary-searches into the sorted hot set C_s:
                serve ``cache_feats[pos]``.
  3. PULLED  -- otherwise keep the pre-scattered residual row
                (``pulled[i]``; zeros for padding ids).

``assemble_ref`` is the where-chain oracle (the ``"ref"`` backend);
``select_ref`` is the plain version of the CUDA select kernel, taking
the ``search`` outputs exactly as the kernel does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cache_lookup.ref import SENTINEL

#: per-row source selector values
SRC_PULLED, SRC_CACHE, SRC_LOCAL = 0, 1, 2


def assemble_ref(table: torch.Tensor, base: int, cache_ids: torch.Tensor,
                 cache_feats: torch.Tensor, query: torch.Tensor,
                 pulled: torch.Tensor) -> torch.Tensor:
    """table (n_per, d); base first device slot; cache_ids (n_hot,)
    sorted int32; cache_feats (n_hot, d); query (m,) int32 (-1 padded);
    pulled (m, d) -> (m, d) assembled features."""
    n_per = table.shape[0]
    slot = query.long() - base
    local = (slot >= 0) & (slot < n_per)
    rows_local = table[slot.clamp(0, n_per - 1)]
    n_hot = cache_ids.shape[0]
    if n_hot == 0:
        return torch.where(local[:, None], rows_local, pulled)
    pos = torch.searchsorted(cache_ids, query)
    pos_c = pos.clamp(max=n_hot - 1)
    hit = ((cache_ids[pos_c] == query) & (query >= 0)
           & (query != SENTINEL))    # sentinel queries never hit
    rows_cache = cache_feats[pos_c]
    return torch.where(local[:, None], rows_local,
                       torch.where(hit[:, None], rows_cache, pulled))


def classify(query: torch.Tensor, pos: torch.Tensor, hit: torch.Tensor,
             base: int, n_per: int, n_hot: int):
    """-> (src (m,) selector, cpos (m,) cache row, lslot (m,) shard slot);
    gather indices are clamped in range so every row stays addressable
    (its selector never picks the clamped source)."""
    slot = query.long() - base
    local = (slot >= 0) & (slot < n_per)
    src = torch.where(local, SRC_LOCAL,
                      torch.where(hit, SRC_CACHE, SRC_PULLED))
    cpos = pos.long().clamp(max=max(n_hot - 1, 0))
    lslot = slot.clamp(0, n_per - 1)
    return src, cpos, lslot


def select_ref(table: torch.Tensor, base: int, cache_feats: torch.Tensor,
               query: torch.Tensor, pos: torch.Tensor, hit: torch.Tensor,
               pulled: torch.Tensor) -> torch.Tensor:
    """The select pass: every output row is a copy of its winning row."""
    src, cpos, lslot = classify(query, pos, hit, base, table.shape[0],
                                cache_feats.shape[0])
    return torch.where(
        (src == SRC_LOCAL)[:, None], table[lslot],
        torch.where((src == SRC_CACHE)[:, None], cache_feats[cpos], pulled))
