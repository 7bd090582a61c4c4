"""Plain PyTorch versions of the feature assembly.

Semantics of one assembled row (priority order, as the JAX package's
``repro/kernels/assemble/ref.py``):

  1. LOCAL   -- the queried device id falls in this worker's shard
                (``base <= q < base + n_per``): serve ``table[q - base]``.
  2. CACHED  -- the id binary-searches into the sorted hot set C_s:
                serve ``cache_feats[pos]``.
  3. PULLED  -- otherwise keep the pre-scattered residual row
                (``pulled[i]``; zeros for padding ids).

``assemble_ref`` is the where-chain oracle: the ``"ref"`` backend and
the plain version of the fused CUDA kernel, which ranks, classifies and
copies in one pass.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.cache_lookup.ref import SENTINEL


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

