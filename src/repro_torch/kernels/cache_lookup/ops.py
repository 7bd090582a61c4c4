"""Public wrapper of the ``search`` kernel.

CPU tensors (or ``interpret=True``) take the plain PyTorch version in
``ref.py``; CUDA tensors launch the CUDA kernel or raise -- there is no
fallback. Contract of the TPU kernel it replaces
(``repro/kernels/cache_lookup/cache_lookup.py:65``): an empty cache
becomes one INT32_MAX sentinel row, queries pad with -1, and a sentinel
query never hits.

Bound on the card: bytes -- the query, pos and hit vectors (9 bytes a
query) plus the sorted ids once; the design (one thread per query, a
binary search over ids that stay in L1/L2) reads each of them once.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.cache_lookup.cache_lookup import launch_search
from repro_torch.kernels.cache_lookup.ref import SENTINEL, search_ref

LAUNCHES = LaunchCount("search")


def search(cache_ids: torch.Tensor, query: torch.Tensor, *,
           interpret: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache_ids (n_hot,) sorted int32; query (m,) int32 ->
    (pos (m,) int32 = #{ids < q}, hit (m,) bool)."""
    expect(cache_ids, "cache_ids", torch.int32, 1)
    expect(query, "query", torch.int32, 1)
    plain = use_plain(interpret, cache_ids, query)
    m = query.shape[0]
    if cache_ids.shape[0] == 0:
        cache_ids = torch.full((1,), SENTINEL, dtype=torch.int32,
                               device=query.device)
    if plain:
        return search_ref(cache_ids, query)
    pos = torch.empty(m, dtype=torch.int32, device=query.device)
    hit = torch.empty(m, dtype=torch.bool, device=query.device)
    if m == 0:
        return pos, hit
    launch_search(cache_ids, query, pos, hit)
    LAUNCHES.bump()
    return pos, hit
