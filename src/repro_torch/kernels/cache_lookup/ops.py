"""Public wrappers of the hot-set lookup kernels: ``search``,
``merge_gather`` and their composition ``cache_lookup``.

CPU tensors (or ``interpret=True``) take the plain PyTorch versions in
``ref.py``; CUDA tensors launch the CUDA kernels or raise -- there is no
fallback. Device ids are int32; ``to_device_ids`` maps the int64 host
sentinel ``CACHE_PAD`` to INT32_MAX, and queries use -1 for padding.

``search`` keeps the contract of the TPU kernel it replaces
(``repro/kernels/cache_lookup/cache_lookup.py:65``): an empty cache
becomes one INT32_MAX sentinel row, queries pad with -1, and a sentinel
query never hits. Bound on the card: bytes -- the query, pos and hit
vectors (9 bytes a query) plus the sorted ids once; the design (a
shared-memory splitter table a block, then a lower bound inside one
32-id line a query) reads each query once and one line of ids a query
after the shared level. The
fused assembly (``kernels/assemble``) ranks inside its own kernel and
never launches this one.

``merge_gather`` keeps the contract of ``cache_lookup.py:111``: ``pos``
clamps to ``n_hot - 1``, a hit takes the cached row cast to ``base``'s
dtype, and an empty cache returns ``base`` itself with no launch. Bound
on the card: bytes, one row read from its winning source and one row
written per query; the design never reads a losing row.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import LaunchCount, expect, use_plain
from repro_torch.kernels.cache_lookup.cache_lookup import (
    DTYPE_CODES, launch_merge_gather, launch_search)
from repro_torch.kernels.cache_lookup.ref import (SENTINEL, merge_gather_ref,
                                                  search_ref)

LAUNCHES = LaunchCount("search")
MERGE_LAUNCHES = LaunchCount("merge_gather")


def to_device_ids(ids64: torch.Tensor) -> torch.Tensor:
    """Clamp the int64 ``CACHE_PAD`` sentinel (and anything above it)
    into int32 space: integer ids -> int32 ids on the same device."""
    return torch.clamp(ids64, max=SENTINEL).to(torch.int32)


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


def merge_gather(cache_feats: torch.Tensor, base: torch.Tensor,
                 pos: torch.Tensor, hit: torch.Tensor, *,
                 interpret: bool = False) -> torch.Tensor:
    """cache_feats (n_hot, d) float32/bfloat16; base (m, d) pre-filled
    buffer, float32/bfloat16; pos (m,) int32; hit (m,) bool -> (m, d) in
    base's dtype, cached rows winning where hit.

    An empty cache returns ``base`` itself, not a copy (nothing can hit,
    and the reference returns its input): a caller must not write into
    the result."""
    for t, name in ((cache_feats, "cache_feats"), (base, "base")):
        if t.dtype not in DTYPE_CODES:
            raise ValueError(f"{name}: expected float32 or bfloat16 rows, "
                             f"got {t.dtype}")
        expect(t, name, t.dtype, 2)
    expect(pos, "pos", torch.int32, 1)
    expect(hit, "hit", torch.bool, 1)
    m, d = base.shape
    if cache_feats.shape[1] != d:
        raise ValueError(f"feature widths differ: cache {cache_feats.shape[1]}"
                         f", base {d}")
    if not pos.shape[0] == hit.shape[0] == m:
        raise ValueError("pos/hit/base row counts differ")
    plain = use_plain(interpret, cache_feats, base, pos, hit)
    if cache_feats.shape[0] == 0:
        return base
    if plain:
        return merge_gather_ref(cache_feats, base, pos, hit)
    out = torch.empty_like(base)
    if m == 0 or d == 0:
        return out
    launch_merge_gather(cache_feats, base, pos, hit, out)
    MERGE_LAUNCHES.bump()
    return out


def cache_lookup(cache_ids: torch.Tensor, cache_feats: torch.Tensor,
                 query: torch.Tensor, base: torch.Tensor, *,
                 interpret: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The C_s merge: ``search`` then ``merge_gather``. cache_ids
    (n_hot,) sorted int32 (INT32_MAX padded); cache_feats (n_hot, d);
    query (m,) int32 (-1 = padding, never hits); base (m, d) -> (merged
    (m, d), hit (m,) bool). An empty cache returns ``base`` itself."""
    pos, hit = search(cache_ids, query, interpret=interpret)
    return merge_gather(cache_feats, base, pos, hit,
                        interpret=interpret), hit
