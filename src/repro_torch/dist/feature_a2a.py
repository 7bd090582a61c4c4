"""Cache-first feature exchange: the device realisation of the paper's
VectorPull / SyncPull over the flat worker axis, the port of
``repro/dist/feature_a2a.py``.

Host-sim counterpart: ``repro_torch.core.fetch.ShardedFeatureStore``.
Here the "distributed KV store" is a partition-sharded feature table
resident in device memory -- ``table[(P, n_per, d)]`` -- and a remote
fetch is one all-to-all round trip:

  1. every worker sends each owner the (deduped, offline-enumerated) slot
     requests it needs from that owner   -- ids up the wire,
  2. each owner gathers the rows from its local shard,
  3. a second all-to-all returns the rows, which the requester
     scatters into its padded (m_max, d) batch buffer by ``send_pos``.

The request matrix is the pull-plan wire format, built OFFLINE by
``build_pull_plan`` / ``pack_pull_lanes`` from the deterministic
schedule (numpy, copied from the reference and pinned to it bit for bit
by the tests), so every exchange has static shapes.

Two forms of the exchange:

  * ``pull_shard`` -- one rank's body over a ``torch.distributed``
    process group, both legs ``all_to_all_single`` (one process per
    worker, as on a machine with one card per worker).
  * ``pull_features`` -- all P workers in one process on one device
    (``dist.mesh.Mesh``): both legs become a transposition of the
    (P, P, k) lane axes, with the same owner-side gather and the same
    masked scatter, so the buffers are bit-equal to ``pull_shard``'s.

The scatter keeps the reference's zero-initialised scatter-add
(``index_add_``), not a copy: padding lanes ask for owner slot 0 and add
an exact zero into row 0, every real position receives exactly one
nonzero contribution, so the sum is order-free (deterministic even with
the card's atomics) and a ``-0.0`` feature becomes ``+0.0`` as in the
reference. Ids, lanes and sentinels stay int32; they widen to int64 only
to index.

The two-tier (hierarchical topology) plans and exchange,
``pack_pull_lanes_two_tier`` and ``pull_shard_two_tier``, wait for
ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.cache_lookup.ops import cache_lookup


@dataclasses.dataclass(frozen=True)
class PullPlan:
    """One worker's residual-miss requests for one batch.

    Wire format (DESIGN.md §6.2): row ``p`` of each array is this
    worker's request lane to owner ``p``; lanes are padded to the
    epoch-level ``k_max`` so every step reuses one compiled program.
    ``send_pos`` is the destination row in the requester's padded
    (m_max, d) feature buffer -- the owner never needs it, it rides
    along host-side only.
    """
    send_ids: np.ndarray    # (P, k_max) int32  requested ids (0 padded)
    send_pos: np.ndarray    # (P, k_max) int32  dst row in the batch buffer
    send_mask: np.ndarray   # (P, k_max) bool   lane validity
    counts: np.ndarray      # (P,) int32        true request count per owner

    @property
    def k_max(self) -> int:
        return int(self.send_ids.shape[1])

    def payload_bytes(self, row_bytes: int) -> int:
        """Feature bytes actually requested (un-padded)."""
        return int(self.counts.sum()) * row_bytes

    def wire_bytes(self, row_bytes: int) -> int:
        """Feature bytes moved by the padded all_to_all return leg."""
        return int(self.send_ids.size) * row_bytes

    def request_bytes(self) -> int:
        """Id bytes moved by the padded all_to_all REQUEST leg (the
        first collective in ``pull_shard`` ships the full (P, k_max)
        int32 id matrix) -- previously unaccounted, so the return leg's
        ``wire_bytes`` understated the true wire total by P*k_max*4."""
        return int(self.send_ids.size) * int(self.send_ids.itemsize)


def build_pull_plan(ids: np.ndarray, pos: np.ndarray, owner: np.ndarray,
                    num_parts: int, k_max: int) -> PullPlan:
    """Pack (id -> buffer position) requests into per-owner lanes.

    ids (m,) requested node ids (negative = padding, dropped); pos (m,)
    destination rows, same length; owner (N,) id -> owning worker. Exact
    duplicate (id, pos) pairs are deduped to one lane slot; the same id
    at *distinct* positions keeps one slot per position (each output row
    must receive its feature -- ids are already unique per batch in the
    GNN path, where the sampler dedupes ``input_nodes``).

    Raises ValueError when any owner's request count exceeds ``k_max``
    (silent truncation would drop features and corrupt training).
    """
    ids = np.asarray(ids)
    pos = np.asarray(pos)
    if ids.shape != pos.shape:
        raise ValueError(f"ids/pos length mismatch: {ids.shape} vs {pos.shape}")
    valid = ids >= 0
    ids, pos = ids[valid].astype(np.int64), pos[valid].astype(np.int64)
    if ids.size:
        pairs = np.unique(np.stack([ids, pos], axis=1), axis=0)
        ids, pos = pairs[:, 0], pairs[:, 1]
    dest = np.asarray(owner)[ids].astype(np.int64)
    # validate BEFORE bincount: a negative owner would crash it with an
    # opaque "negative values" error, and the historical post-hoc
    # ``counts.size > num_parts`` check only caught the too-HIGH side
    if ids.size and (int(dest.min()) < 0 or int(dest.max()) >= num_parts):
        raise ValueError(f"owner id out of range: [{dest.min()}, "
                         f"{dest.max()}] not in [0, {num_parts})")
    counts = np.bincount(dest, minlength=num_parts).astype(np.int32)
    if ids.size and int(counts.max()) > k_max:
        over = np.flatnonzero(counts > k_max)
        raise ValueError(
            f"pull plan overflow: owners {over.tolist()} requested "
            f"{counts[over].tolist()} rows > k_max={k_max}; raise k_max "
            f"(epoch_k_max gives the exact bound)")

    send_ids = np.zeros((num_parts, k_max), np.int32)
    send_pos = np.zeros((num_parts, k_max), np.int32)
    send_mask = np.zeros((num_parts, k_max), bool)
    order = np.argsort(dest, kind="stable")
    start = np.zeros(num_parts + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    lane = np.arange(ids.size) - start[dest[order]]
    send_ids[dest[order], lane] = ids[order].astype(np.int32)
    send_pos[dest[order], lane] = pos[order].astype(np.int32)
    send_mask[dest[order], lane] = True
    return PullPlan(send_ids=send_ids, send_pos=send_pos,
                    send_mask=send_mask, counts=counts)


def _fast_key_fits(num_groups: int, num_parts: int, span_i: int,
                   span_p: int) -> bool:
    """True when the rebased composite (group, id, pos) key fits int64
    headroom (< 2**62), i.e. the single-sort fast path is safe. Spans
    are REBASED extents (``max - min + 1``), not absolute maxima --
    exposed for the boundary regression tests."""
    return num_groups * num_parts * span_i * span_p < 2 ** 62


def pack_pull_lanes(ids: np.ndarray, pos: np.ndarray, group: np.ndarray,
                    owner: np.ndarray, num_groups: int, num_parts: int,
                    k_max: int, assume_unique: bool = False):
    """Batched ``build_pull_plan``: pack MANY batches' requests into
    per-(group, owner) lanes in one vectorized pass (DESIGN.md §6.6).

    ids/pos/group/owner are aligned (n,) arrays -- one element per
    requested (id -> buffer position), ``group`` the flat batch ordinal
    (e.g. ``step * P + worker``) and ``owner`` the owning worker of each
    id. Negative ids (padding) are dropped; exact (group, id, pos)
    duplicates collapse to one lane slot; lanes within a (group, owner)
    pair are ordered by ascending (id, pos) -- all three semantics
    identical to calling ``build_pull_plan`` once per group, which the
    collation parity tests pin. ``assume_unique=True`` skips the dedupe
    pass -- valid when ids are unique within each group, the sampler's
    ``input_nodes`` invariant.

    -> (send_ids, send_pos, send_mask) of shape (num_groups, num_parts,
    k_max) plus counts (num_groups, num_parts). Raises on lane overflow
    (silent truncation would corrupt training) and out-of-range owners.
    """
    ids = np.asarray(ids, dtype=np.int64)       # no copy when already i64
    pos = np.asarray(pos, dtype=np.int64)
    group = np.asarray(group, dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64)
    valid = ids >= 0
    if not valid.all():
        ids, pos, group, owner = (a[valid] for a in (ids, pos, group,
                                                     owner))
    if ids.size and (owner.min() < 0 or owner.max() >= num_parts):
        raise ValueError(f"owner id out of range: [{owner.min()}, "
                         f"{owner.max()}] not in [0, {num_parts})")
    shape = (num_groups, num_parts, k_max)
    send_ids = np.zeros(shape, np.int32)
    send_pos = np.zeros(shape, np.int32)
    send_mask = np.zeros(shape, bool)
    counts = np.zeros((num_groups, num_parts), np.int32)
    if not ids.size:
        return send_ids, send_pos, send_mask, counts
    gidx = group * num_parts + owner
    # (group, id, pos) ordering via ONE composite int64 key when the
    # value ranges allow it -- a single introsort beats the 3-key
    # lexsort ~3x at epoch scale. Stability is irrelevant: the key is
    # unique per lane except for EXACT duplicates, which dedupe anyway.
    # Keys are REBASED to the observed min so only the id/pos SPANS
    # spend key bits: a large device-id base (big P*n_per meshes put
    # every id near P*n_per) must not push an epoch whose actual id
    # range is tiny onto the slow lexsort fallback.
    imin, pmin = int(ids.min()), int(pos.min())
    span_i = int(ids.max()) - imin + 1
    span_p = int(pos.max()) - pmin + 1
    if _fast_key_fits(num_groups, num_parts, span_i, span_p):
        key = (gidx * span_i + (ids - imin)) * span_p + (pos - pmin)
        order = np.argsort(key)
        if not assume_unique:
            k_s = key[order]
            keep = np.ones(k_s.size, bool)  # drop exact duplicate lanes
            keep[1:] = k_s[1:] != k_s[:-1]
            order = order[keep]
    else:                                   # huge spans: lexsort fallback
        order = np.lexsort((pos, ids, gidx))
        if not assume_unique:
            g0, i0, p0 = gidx[order], ids[order], pos[order]
            keep = np.ones(g0.size, bool)
            keep[1:] = ((g0[1:] != g0[:-1]) | (i0[1:] != i0[:-1])
                        | (p0[1:] != p0[:-1]))
            order = order[keep]
    g_s, i_s, p_s = gidx[order], ids[order], pos[order]
    cnt = np.bincount(g_s, minlength=num_groups * num_parts)
    if int(cnt.max()) > k_max:
        over = np.flatnonzero(cnt > k_max)
        raise ValueError(
            f"pull plan overflow: (group, owner) pairs "
            f"{[divmod(int(o), num_parts) for o in over[:8].tolist()]} "
            f"requested {cnt[over[:8]].tolist()} rows > k_max={k_max}; "
            f"raise k_max (epoch_k_max gives the exact bound)")
    start = np.zeros(cnt.size + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    lane = np.arange(g_s.size) - start[g_s]
    flat = g_s * k_max + lane
    send_ids.reshape(-1)[flat] = i_s.astype(np.int32)
    send_pos.reshape(-1)[flat] = p_s.astype(np.int32)
    send_mask.reshape(-1)[flat] = True
    counts[:] = cnt.reshape(num_groups, num_parts)
    return send_ids, send_pos, send_mask, counts


def _scatter(got: torch.Tensor, send_pos: torch.Tensor,
             send_mask: torch.Tensor, rows: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked scatter-add of the returned rows: got (..., k, d) lanes,
    send_pos/send_mask (..., k) -> (rows, d), zero where nothing lands.
    ``send_pos`` already holds flat row numbers of the result."""
    d = got.shape[-1]
    pos = torch.where(send_mask, send_pos, 0).reshape(-1).long()
    contrib = torch.where(send_mask.reshape(-1, 1), got.reshape(-1, d),
                          torch.zeros((), dtype=got.dtype,
                                      device=got.device))
    if out is None:
        out = torch.zeros((rows, d), dtype=got.dtype, device=got.device)
    else:
        out.zero_()
    return out.index_add_(0, pos, contrib)


def pull_shard(table: torch.Tensor, send_ids: torch.Tensor,
               send_pos: torch.Tensor, send_mask: torch.Tensor, base: int,
               m_max: int, group=None) -> torch.Tensor:
    """One rank's exchange over a ``torch.distributed`` process group
    (the port of the reference's per-device ``pull_shard`` body).

    table (n_per, d) this worker's shard; send_* (G, k) its request
    lanes, row g addressed to rank g of ``group`` (G = its size); base
    this worker's first global slot. -> (m_max, d) buffer with the
    requested rows scattered to ``send_pos`` (other rows zero). Padding
    lanes may request owner slot 0; the requester's send_mask zeroes
    them at the scatter, so the mask never crosses the wire.
    """
    import torch.distributed as dist

    n_per, d = table.shape
    req = torch.empty_like(send_ids)
    dist.all_to_all_single(req, send_ids.contiguous(), group=group)
    slot = (req.long() - int(base)).clamp(0, n_per - 1)
    rows = table[slot]                                    # (G, k, d) serve
    got = torch.empty_like(rows)
    dist.all_to_all_single(got, rows, group=group)        # (G, k, d) mine
    return _scatter(got, send_pos, send_mask, m_max)


def pull_features(mesh, table: torch.Tensor, send_ids: torch.Tensor,
                  send_pos: torch.Tensor, send_mask: torch.Tensor,
                  offsets: torch.Tensor, m_max: int, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-worker exchange against the partition-sharded table, all P
    workers in one process on ``mesh``'s device.

    table (P, n_per, d); send_* (P, P, k_max) -- dim 0 the requesting
    worker, dim 1 the owner lane; offsets (P,) or (P, 1) first global
    slot of each partition. -> (P, m_max, d) per-worker scattered
    feature buffers (written into ``out`` when given).

    The request leg is ``send_ids.transpose(0, 1)``: owner o's row r
    holds what requester r asked of it. Each owner clamps the slots into
    its shard, and the row leg transposes back; the transposition is
    taken on the slot indices, so the rows are gathered once, already in
    the requester's lane order -- the same rows the reference's gather
    followed by its all-to-all delivers.
    """
    P_, n_per, d = table.shape
    if mesh.num_workers != P_ or send_ids.shape[:2] != (P_, P_):
        raise ValueError(f"a {mesh.num_workers}-worker mesh, a table of "
                         f"{P_} shards and lanes {tuple(send_ids.shape)}")
    offs = offsets.reshape(-1).long()
    req = send_ids.transpose(0, 1)                        # (owner, req, k)
    slot = (req.long() - offs[:, None, None]).clamp(0, n_per - 1)
    row = slot + (torch.arange(P_, device=table.device) * n_per)[:, None,
                                                                 None]
    got = table.reshape(P_ * n_per, d)[row.transpose(0, 1)]  # (req, own, k, d)
    flat_pos = send_pos + (torch.arange(P_, dtype=send_pos.dtype,
                                        device=send_pos.device)
                           * m_max)[:, None, None]
    flat_out = None if out is None else out.view(P_ * m_max, d)
    return _scatter(got, flat_pos, send_mask, P_ * m_max,
                    out=flat_out).view(P_, m_max, d)


def cache_gather(cache_ids: torch.Tensor, cache_feats: torch.Tensor,
                 query: torch.Tensor, base: torch.Tensor):
    """Hot-set C_s merge: overlay cache hits onto a pre-filled buffer.

    cache_ids (n_hot,) SORTED int32 (INT32_MAX padded); cache_feats
    (n_hot, d); query (m,) int32 ids (-1 = padding, never hits); base
    (m, d) buffer already holding pulled/local rows. -> (merged,
    hit_mask). On CUDA tensors this launches the ``search`` and
    ``merge_gather`` kernels; on the CPU it runs their plain versions.
    An empty cache returns ``base`` itself.
    """
    return cache_lookup(cache_ids, cache_feats, query, base)
