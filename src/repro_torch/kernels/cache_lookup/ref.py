"""Plain PyTorch versions of the ``search`` and ``merge_gather``
kernels, and of the whole hot-set lookup (``cache_lookup_ref``, the
port of ``repro/kernels/cache_lookup/ref.py``)."""
from __future__ import annotations

from typing import Tuple

import torch

#: int32 cache sentinel: compares >= every real device id, so padding the
#: cache-id vector with it never perturbs ``pos`` or ``hit``
SENTINEL = 2 ** 31 - 1


def search_ref(cache_ids: torch.Tensor, query: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache_ids (n_hot,) sorted non-negative int32; query (m,) int32 ->
    (pos (m,) int32 = #{ids < q}, hit (m,) bool = q in ids). Sentinel
    queries never hit; -1 padding never hits (ids are non-negative)."""
    n_hot = cache_ids.shape[0]
    if n_hot == 0:
        return (torch.zeros_like(query),
                torch.zeros(query.shape, dtype=torch.bool,
                            device=query.device))
    # left insertion point of a sorted vector == #{ids < q}
    pos = torch.searchsorted(cache_ids, query, out_int32=True)
    pos_c = pos.clamp(max=n_hot - 1).long()
    hit = (cache_ids[pos_c] == query) & (query != SENTINEL)
    return pos, hit


def merge_gather_ref(cache_feats: torch.Tensor, base: torch.Tensor,
                     pos: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """cache_feats (n_hot, d); base (m, d); pos (m,) int32; hit (m,)
    bool -> (m, d) in base's dtype: the cached row (cast) where hit, the
    base row elsewhere, with pos clamped into [0, n_hot - 1] as the kernel
    clamps it (a rank is never negative). An empty cache
    returns ``base`` itself (nothing can hit); callers never write into
    the result."""
    n_hot = cache_feats.shape[0]
    if n_hot == 0:
        return base
    vals = cache_feats[pos.clamp(0, n_hot - 1).long()]
    return torch.where(hit[:, None], vals.to(base.dtype), base)


def cache_lookup_ref(cache_ids: torch.Tensor, cache_feats: torch.Tensor,
                     query: torch.Tensor, base: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache_ids (n_hot,) sorted (padded with the sentinel); cache_feats
    (n_hot, d); query (m,); base (m, d) pre-filled buffer -> (merged (m,
    d), hit (m,) bool). Padding (-1) and sentinel queries never hit; an
    empty cache returns ``base`` itself."""
    n_hot = cache_ids.shape[0]
    if n_hot == 0:
        return base, torch.zeros(query.shape, dtype=torch.bool,
                                 device=query.device)
    pos = torch.searchsorted(cache_ids, query)
    pos_c = pos.clamp(max=n_hot - 1)
    hit = (cache_ids[pos_c] == query) & (query >= 0) & (query != SENTINEL)
    merged = torch.where(hit[:, None], cache_feats[pos_c].to(base.dtype),
                         base)
    return merged, hit
