"""Plain PyTorch version of the ``search`` kernel."""
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
