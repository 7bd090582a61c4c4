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
    (``dist.mesh.Mesh``): both legs become a gather of each lane's row
    from its owner's shard, with the same owner-side clamp and the same
    masked scatter, so the buffers are bit-equal to ``pull_shard``'s.

On a hierarchical topology (``dist.topology.Topology``) the plan is
TWO-TIER: ``pack_pull_lanes_two_tier`` splits each worker's misses by
whether the owner shares its host -- same-host lanes address the owner
by its LOCAL device index (the intra-host exchange spans D peers),
cross-host lanes by its flat ordinal (the exchange over all P). The
union of the two tiers is bit-equal to the flat plan, and both forms of
the two-tier exchange (``pull_shard_two_tier`` over an intra-host
subgroup and the world, ``pull_features_two_tier`` in one process)
scatter both tiers' disjoint contributions into one zero buffer, so
their buffers are bit-equal to the flat pull's.

The scatter keeps the reference's zero-initialised scatter-add
(``index_add_``), not a copy: padding lanes ask for owner slot 0 and add
an exact zero into row 0, every real position receives exactly one
nonzero contribution, so the sum is order-free (deterministic even with
the card's atomics) and a ``-0.0`` feature becomes ``+0.0`` as in the
reference. Ids, lanes and sentinels stay int32; they widen to int64 only
to index.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

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


def lane_overflow(cnt: np.ndarray, num_parts: int, k_max: int
                  ) -> ValueError:
    """The error of a lane packing whose (group, owner) counts ``cnt``
    (flat over ``group * num_parts + owner``) pass ``k_max``."""
    over = np.flatnonzero(cnt > k_max)
    return ValueError(
        f"pull plan overflow: (group, owner) pairs "
        f"{[divmod(int(o), num_parts) for o in over[:8].tolist()]} "
        f"requested {cnt[over[:8]].tolist()} rows > k_max={k_max}; "
        f"raise k_max (epoch_k_max gives the exact bound)")


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
        raise lane_overflow(cnt, num_parts, k_max)
    start = np.zeros(cnt.size + 1, np.int64)
    np.cumsum(cnt, out=start[1:])
    lane = np.arange(g_s.size) - start[g_s]
    flat = g_s * k_max + lane
    send_ids.reshape(-1)[flat] = i_s.astype(np.int32)
    send_pos.reshape(-1)[flat] = p_s.astype(np.int32)
    send_mask.reshape(-1)[flat] = True
    counts[:] = cnt.reshape(num_groups, num_parts)
    return send_ids, send_pos, send_mask, counts


def pack_pull_lanes_two_tier(ids: np.ndarray, pos: np.ndarray,
                             group: np.ndarray, owner: np.ndarray,
                             requester: np.ndarray, num_groups: int,
                             topo, k_max_intra: int, k_max_inter: int,
                             assume_unique: bool = False):
    """Topology-aware ``pack_pull_lanes``: split each request by whether
    its owner shares the requester's host.

    ``requester`` is the flat worker ordinal issuing each request,
    aligned with ids/pos/group/owner; ``topo`` a
    ``dist.topology.Topology``. Same-host requests pack into
    ``(num_groups, D, k_max_intra)`` lanes addressed by the owner's
    LOCAL device index (the intra-host exchange only spans D peers);
    cross-host requests pack into ``(num_groups, P, k_max_inter)`` lanes
    addressed by the owner's flat ordinal (the exchange over all P).
    Ids stay GLOBAL in both tiers -- the serving side's slot arithmetic
    is base-relative regardless of which wire the request rode.

    -> (intra, inter): two ``pack_pull_lanes``-shaped 4-tuples
    (send_ids, send_pos, send_mask, counts). Their union is bit-equal
    to the flat-mesh ``pack_pull_lanes`` output (each lane appears in
    exactly one tier, same per-(group, owner) ascending (id, pos)
    order).
    """
    ids = np.asarray(ids, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    group = np.asarray(group, dtype=np.int64)
    owner = np.asarray(owner, dtype=np.int64)
    requester = np.asarray(requester, dtype=np.int64)
    valid = ids >= 0
    if not valid.all():
        ids, pos, group, owner, requester = (
            a[valid] for a in (ids, pos, group, owner, requester))
    P_ = topo.num_workers
    if ids.size and (owner.min() < 0 or owner.max() >= P_):
        raise ValueError(f"owner id out of range: [{owner.min()}, "
                         f"{owner.max()}] not in [0, {P_})")
    same = topo.same_host(owner, requester)
    intra = pack_pull_lanes(
        ids[same], pos[same], group[same], topo.local_of(owner[same]),
        num_groups, topo.devices_per_host, k_max_intra,
        assume_unique=assume_unique)
    inter = pack_pull_lanes(
        ids[~same], pos[~same], group[~same], owner[~same],
        num_groups, P_, k_max_inter, assume_unique=assume_unique)
    return intra, inter


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


def _all_to_all(req: torch.Tensor, table: torch.Tensor, base: int,
                group) -> torch.Tensor:
    """Both legs over ``group``: ``req`` (G, k) ids, row g to rank g ->
    (G, k, d) the rows the ranks served back, in ``req``'s lane order.
    The owner clamps each asked slot into its shard (a padding lane's
    id lands on some real row; the requester's mask drops it)."""
    import torch.distributed as dist

    asks = torch.empty_like(req)
    dist.all_to_all_single(asks, req.contiguous(), group=group)
    slot = (asks.long() - int(base)).clamp(0, table.shape[0] - 1)
    rows = table[slot]                                    # (G, k, d) serve
    got = torch.empty_like(rows)
    dist.all_to_all_single(got, rows, group=group)        # (G, k, d) mine
    return got


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
    got = _all_to_all(send_ids, table, base, group)
    return _scatter(got, send_pos, send_mask, m_max)


def pull_shard_two_tier(table: torch.Tensor, send: Dict[str, torch.Tensor],
                        base: int, m_max: int, ici_group,
                        world_group=None) -> torch.Tensor:
    """One rank's two-tier exchange: ``send`` holds the lanes of
    ``pack_pull_lanes_two_tier`` -- ``intra_*`` (D, k_i) exchanged over
    ``ici_group``, the D ranks of this rank's host (lane d to its local
    rank d), and ``inter_*`` (P, k_x) over ``world_group`` (all P ranks,
    ``None`` for the default group). The tiers' request sets are
    disjoint, and both tiers' rows go through one masked scatter-add
    into one zero buffer, so the result is bit-equal to ``pull_shard``
    on the flat plan."""
    got = [_all_to_all(send["intra_ids"], table, base, ici_group),
           _all_to_all(send["inter_ids"], table, base, world_group)]
    return _scatter_tiers(got, send, m_max)


def _scatter_tiers(got, send: Dict[str, torch.Tensor], rows: int,
                   row_base: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both tiers' returned rows -- got[0] (..., D, k_i, d) intra,
    got[1] (..., P, k_x, d) inter -- through one masked scatter-add.
    ``row_base`` (..., 1) is added to ``send_pos`` (the first row of
    each requester's buffer when the buffers are stacked)."""
    lead, d = got[0].shape[:-3], got[0].shape[-1]
    tiers = ("intra", "inter")
    rows_in = torch.cat([g.reshape(*lead, -1, d) for g in got], dim=-2)
    pos = torch.cat([send[f"{t}_pos"].reshape(*lead, -1) for t in tiers],
                    dim=-1)
    mask = torch.cat([send[f"{t}_mask"].reshape(*lead, -1) for t in tiers],
                     dim=-1)
    if row_base is not None:
        pos = pos + row_base
    return _scatter(rows_in, pos, mask, rows, out=out)


def _check_mesh(mesh, table: torch.Tensor) -> None:
    if mesh.model > 1:
        raise ValueError(f"the feature exchange runs over data workers; a "
                         f"mesh of {mesh.model} model shards a worker "
                         f"({mesh.shape}) is the transformer's")
    if mesh.num_workers != table.shape[0]:
        raise ValueError(f"a {mesh.num_workers}-worker mesh and a table of "
                         f"{table.shape[0]} shards")


def _lane_rows(table: torch.Tensor, ids: torch.Tensor, owner: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """Every lane's row, served by its owner: ids (P, G, k) requests,
    owner (P, G, 1) the owning worker of each lane row -> (P, G, k, d),
    the rows each owner serves back along the lane (slots clamped into
    its shard, as in ``_all_to_all``)."""
    P_, n_per, d = table.shape
    slot = (ids.long() - offs[owner]).clamp(0, n_per - 1)
    return table.reshape(P_ * n_per, d)[owner * n_per + slot]


def _row_base(P_: int, m_max: int, like: torch.Tensor) -> torch.Tensor:
    """(P, 1): the first row of each requester's buffer in the stacked
    (P * m_max, d) output."""
    return (torch.arange(P_, dtype=like.dtype, device=like.device)
            * m_max)[:, None]


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

    Both legs of the reference's all-to-all become one gather: lane
    (r, o, j) takes row ``send_ids[r, o, j] - offsets[o]`` of owner o's
    shard, clamped into it -- the rows owner o serves to requester r,
    already in r's lane order.
    """
    P_, _, d = table.shape
    _check_mesh(mesh, table)
    if send_ids.shape[:2] != (P_, P_):
        raise ValueError(f"lanes {tuple(send_ids.shape)} for {P_} workers")
    owner = torch.arange(P_, device=table.device)[None, :, None]
    got = _lane_rows(table, send_ids, owner, offsets.reshape(-1).long())
    flat_pos = send_pos + _row_base(P_, m_max, send_pos)[:, :, None]
    flat_out = None if out is None else out.view(P_ * m_max, d)
    return _scatter(got, flat_pos, send_mask, P_ * m_max,
                    out=flat_out).view(P_, m_max, d)


def pull_features_two_tier(mesh, table: torch.Tensor,
                           send: Dict[str, torch.Tensor],
                           offsets: torch.Tensor, m_max: int, *,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``pull_features`` over the two-tier lanes of
    ``pack_pull_lanes_two_tier``, all P workers of ``mesh`` (H hosts of
    D) in one process: ``intra_*`` (P, D, k_i), lane d of requester r
    addressed to worker ``(r // D) * D + d``; ``inter_*`` (P, P, k_x),
    lane o to worker o. Both tiers' rows go through one masked
    scatter-add into one zero buffer per requester, bit-equal to
    ``pull_features`` on the flat plan."""
    P_, _, d = table.shape
    _check_mesh(mesh, table)
    D = mesh.devices_per_host
    if send["intra_ids"].shape[:2] != (P_, D) or \
            send["inter_ids"].shape[:2] != (P_, P_):
        raise ValueError(
            f"two-tier lanes {tuple(send['intra_ids'].shape)} / "
            f"{tuple(send['inter_ids'].shape)} for {mesh.hosts} hosts of "
            f"{D} workers")
    offs = offsets.reshape(-1).long()
    w = torch.arange(P_, device=table.device)
    intra_owner = ((w // D) * D)[:, None, None] + \
        torch.arange(D, device=table.device)[None, :, None]
    got = [_lane_rows(table, send["intra_ids"], intra_owner, offs),
           _lane_rows(table, send["inter_ids"], w[None, :, None], offs)]
    flat_out = None if out is None else out.view(P_ * m_max, d)
    return _scatter_tiers(got, send, P_ * m_max,
                          row_base=_row_base(P_, m_max,
                                             send["intra_pos"]),
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
