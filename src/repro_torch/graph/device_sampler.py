"""Whole-epoch schedule compiler with its sort-bound middle on the card
(the port of the JAX package's ``repro.graph.device_sampler``).

Moves the composite-key segment-unique, frontier membership, new-source
extraction and local-index resolution of
``KHopSampler.sample_epoch_batched`` onto a torch device, with the
``seg_sort`` radix kernel for the key sorts and scatter/gather tables
for the unique-inverse, plus remote-frequency counting and hot-set
ordering. The result is BIT-IDENTICAL to the numpy compiler: every
derived quantity is a deterministic function of the sorted unique key
set (frontier keys are globally distinct and ``np.unique`` outputs are
sets), so no sort-stability caveat survives into the payload.

RNG contract (the part that does NOT move): numpy's
``Generator.integers`` with broadcast (per-row) bounds consumes its
Philox stream data-dependently (masked rejection sampling), which no
fixed-shape device program can replay. The per-batch offset draws
therefore stay on the host -- the EXACT ``rngs[i].integers`` calls
``sample_batch`` makes, one independent stream per ``H(s0, w, e, i)``
(Prop 3.1) -- and the device consumes their output.

Fallbacks (all bit-equal by definition -- they ARE the numpy path):
  * composite key spaces past ``KEY_INT32_MAX_SLOTS`` (the device keys
    are int32, as the reference keeps them),
  * empty epochs (``nb == 0``).

Out-of-range scatter indices: the reference writes its tables with
``.at[i].set(v, mode="drop")``, which drops indices past the end (pad
slots, SENT keys). Torch has no dropping scatter, so ``_scatter_drop``
masks them explicitly: a masked index is sent to one spare slot past
the end, which is cut off. Keys, ranks and tables stay int32 on every
path, so the INT32_MAX sentinel survives every step.

Every function takes its ``device`` explicitly; ``None`` means ``cuda``
and raises without a card. On a CPU device the sorts take the plain
``torch.sort`` version, so the CPU tests run the same code.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.sampler import (FlatEpoch, KEY_INT32_MAX_SLOTS,
                                       KHopSampler, _starts, rng_from)
from repro_torch.kernels.seg_sort.ops import seg_sort

#: int32 padding sentinel: sorts after every real composite key (key
#: spaces are gated below 2^31, so max real key <= 2^31 - 2).
SENT = 2 ** 31 - 1

#: dense scatter-table bound for the unique-inverse / frontier-membership
#: lookups (int32 slots, so at most 256 MB on the card). Wider key
#: spaces use searchsorted instead -- still device ops, just
#: O(n log n) probes instead of O(n) table reads.
DEVICE_TABLE_MAX_SLOTS = 1 << 26

_I32 = torch.int32


def _bucket(n: int) -> int:
    """Power-of-two pad bucket (>= 128), as the reference pads, so the
    streams have the reference's shapes."""
    return 128 if n <= 128 else 1 << (n - 1).bit_length()


def _pad_i32(x: np.ndarray, n_pad: int, device: torch.device,
             fill: int = SENT) -> torch.Tensor:
    out = np.full(n_pad, fill, np.int32)
    out[:x.shape[0]] = x
    return torch.from_numpy(out).to(device)


def _scatter_drop(size: int, fill: int, idx: torch.Tensor,
                  val: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``full(size, fill).at[idx].set(val, mode="drop")`` restricted to
    ``keep``: kept indices are in range and distinct, the rest land in a
    spare slot past the end, which is dropped."""
    out = torch.full((size + 1,), fill, dtype=val.dtype, device=val.device)
    where = torch.where(keep, idx, torch.full_like(idx, size))
    out.scatter_(0, where.long(), val)
    return out[:size]


def _cumsum_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(_I32), 0, dtype=_I32)


def _run_heads(sk: torch.Tensor) -> torch.Tensor:
    """Head flags of the runs of equal keys in a sorted, SENT-padded
    stream (pads are never heads)."""
    first = torch.ones(1, dtype=torch.bool, device=sk.device)
    return (sk != SENT) & torch.cat([first, sk[1:] != sk[:-1]])


# ---------------------------------------------------------------------------
# the per-layer device step
# ---------------------------------------------------------------------------

def _frontier_step(cand_key: torch.Tensor, cur_key: torch.Tensor,
                   cur_within: torch.Tensor, counts: torch.Tensor, *,
                   nb: int, span: int, use_table: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One sampler layer's segment-unique on device.

    cand_key (n_pad,) int32 composite ``batch * span + src`` edge keys,
    SENT-padded; cur_key (c_pad,) the current frontier's composite keys
    (globally unique), SENT-padded; cur_within (c_pad,) each frontier
    node's within-batch position; counts (nb,) per-batch frontier sizes.

    Returns (src_idx, ext_key, ext_counts): per-edge local source index
    into the NEXT frontier (pad slots garbage, host slices), the compact
    ascending stream of new composite keys (SENT-padded), and per-batch
    new-source counts -- exactly ``np.unique`` + setdiff semantics.
    """
    n_pad = cand_key.shape[0]
    dev = cand_key.device
    ks = nb * span
    num_bits = max(int(ks - 1).bit_length(), 1)

    # segment-unique: ONE global sort acts per batch (composite keys
    # never cross segment boundaries), then head flags + compaction
    sk, _ = seg_sort(cand_key, num_bits=num_bits)
    head = _run_heads(sk)
    rank = _cumsum_i32(head) - 1
    uk = _scatter_drop(n_pad, SENT, rank, sk, head)
    valid_u = uk != SENT

    # frontier membership + old-slot resolution
    if use_table:
        # dense probes over the key space: frontier table answers both
        # "is this unique key old" and "at which within-batch position"
        cur_tbl = _scatter_drop(ks, -1, cur_key, cur_within,
                                cur_key < ks)       # SENT pads drop
        old_within = cur_tbl[torch.clamp(uk, max=ks - 1).long()]
    else:
        cks, cw = seg_sort(cur_key, cur_within, num_bits=num_bits)
        pos = torch.clamp(torch.searchsorted(cks, uk, out_int32=True),
                          max=cks.shape[0] - 1).long()
        old_within = torch.where(cks[pos] == uk, cw[pos],
                                 torch.full_like(uk, -1))
    is_new = valid_u & (old_within < 0)

    # compact new sources (ascending per batch == setdiff1d contract)
    ext_rank = _cumsum_i32(is_new) - 1
    n_ext = ext_rank[-1:] + 1
    ext_key = _scatter_drop(n_pad, SENT, ext_rank, uk, is_new)
    bounds = torch.arange(nb, dtype=_I32, device=dev) * span
    ext_starts = torch.cat(
        [torch.searchsorted(ext_key, bounds, out_int32=True), n_ext])
    ext_counts = torch.diff(ext_starts)

    # resolve each UNIQUE key once: old keys sit at their frontier
    # position, new keys at prefix + extra rank; then fan out to edges
    ub = torch.clamp(torch.where(valid_u, uk, torch.zeros_like(uk))
                     // span, 0, nb - 1).long()
    uk_local = torch.where(is_new, counts[ub] + ext_rank - ext_starts[ub],
                           old_within)
    if use_table:
        val_tbl = _scatter_drop(ks, 0, uk, uk_local, uk < ks)
        src_idx = val_tbl[torch.clamp(cand_key, max=ks - 1).long()]
    else:
        inv = torch.searchsorted(uk, torch.clamp(cand_key, max=ks - 1),
                                 out_int32=True)
        src_idx = uk_local[torch.clamp(inv, max=n_pad - 1).long()]
    return src_idx, ext_key, ext_counts


# ---------------------------------------------------------------------------
# the epoch loop (host orchestration + draws, device segment-unique)
# ---------------------------------------------------------------------------

def sample_epoch_batched_device(sampler: KHopSampler, s0: int, worker: int,
                                epoch: int, train_nodes: np.ndarray, *,
                                device: Optional[torch.device] = None
                                ) -> FlatEpoch:
    """Whole-epoch compile with the per-layer segment-unique on
    ``device``; bit-identical to ``sample_epoch_batched`` (the
    differential tests pin it array for array). Falls back to the numpy
    compiler for int64 key spaces and empty epochs."""
    g = sampler.graph
    L = len(sampler.fanouts)
    span = int(g.num_nodes)
    seed_batches = sampler.epoch_seed_batches(s0, worker, epoch,
                                              train_nodes)
    nb = len(seed_batches)
    if nb == 0 or nb * span >= KEY_INT32_MAX_SLOTS:
        return sampler.sample_epoch_batched(s0, worker, epoch, train_nodes)
    device = resolve_device(device)

    seeds_flat = np.concatenate(seed_batches).astype(np.int64)
    seed_counts = np.fromiter((b.shape[0] for b in seed_batches),
                              np.int64, nb)
    seed_starts = _starts(seed_counts)
    rngs = [rng_from(s0, worker, epoch, i) for i in range(nb)]
    use_table = nb * span <= DEVICE_TABLE_MAX_SLOTS
    bids = np.arange(nb, dtype=np.int32)

    cur = seeds_flat                 # flat frontier, batch-segmented
    counts, starts = seed_counts, seed_starts
    num_dst = np.zeros((L, nb), np.int64)
    rev_src: List[np.ndarray] = []
    rev_dst: List[np.ndarray] = []
    rev_mask: List[np.ndarray] = []
    rev_starts: List[np.ndarray] = []

    for j, fanout in enumerate(reversed(sampler.fanouts)):
        num_dst[L - 1 - j] = counts
        batch_of = np.repeat(bids, counts)
        within = np.arange(cur.shape[0], dtype=np.int64) \
            - starts[batch_of]
        deg = (g.indptr[cur + 1] - g.indptr[cur]).astype(np.int64)
        hi = np.maximum(deg, 1)
        offs = np.empty((cur.shape[0], fanout), np.int64)
        for i in range(nb):     # host Philox: the RNG contract
            sl = slice(starts[i], starts[i + 1])
            offs[sl] = rngs[i].integers(
                0, hi[sl][:, None], size=(int(counts[i]), fanout))
        src_pos = g.indptr[cur][:, None] + offs
        zero = np.flatnonzero(deg == 0)
        if zero.size:
            src_pos[zero] = 0
        src_flat = g.indices[src_pos].reshape(-1).astype(np.int32,
                                                         copy=False)
        mask = np.repeat(deg > 0, fanout)
        if zero.size:
            bad = np.flatnonzero(~mask)
            src_flat[bad] = cur[bad // fanout]

        dst_idx = np.repeat(within, fanout).astype(np.int32)
        ecount = counts * fanout
        n_edges = int(ecount.sum())
        cand_key = (np.repeat(bids, ecount).astype(np.int32)
                    * np.int32(span) + src_flat)
        cur_key = (batch_of.astype(np.int32) * np.int32(span)
                   + cur.astype(np.int32, copy=False))

        n_pad, c_pad = _bucket(n_edges), _bucket(cur.shape[0])
        d_src, d_ext, d_cnt = _frontier_step(
            _pad_i32(cand_key, n_pad, device),
            _pad_i32(cur_key, c_pad, device),
            _pad_i32(within.astype(np.int32), c_pad, device, fill=0),
            torch.from_numpy(counts.astype(np.int32)).to(device),
            nb=nb, span=span, use_table=use_table)

        src_idx = d_src[:n_edges].cpu().numpy()
        ext_counts = d_cnt.cpu().numpy().astype(np.int64)
        n_ext = int(ext_counts.sum())
        ext_key = d_ext[:n_ext].cpu().numpy().astype(np.int64)
        ext_batch = ext_key // span
        ext_id = ext_key - ext_batch * span
        ext_starts = _starts(ext_counts)
        ewithin = np.arange(n_ext, dtype=np.int64) \
            - ext_starts[ext_batch]

        # next frontier: dst prefix then the new unique sources
        new_counts = counts + ext_counts
        new_starts = _starts(new_counts)
        new_cur = np.empty(int(new_starts[-1]), np.int64)
        new_cur[new_starts[batch_of] + within] = cur
        new_cur[new_starts[ext_batch] + counts[ext_batch]
                + ewithin] = ext_id

        rev_src.append(src_idx)
        rev_dst.append(dst_idx)
        rev_mask.append(mask)
        rev_starts.append(_starts(ecount))
        cur, counts, starts = new_cur, new_counts, new_starts

    return FlatEpoch(
        epoch=epoch, worker=worker, seeds=seeds_flat,
        seed_starts=seed_starts, input_nodes=cur, input_starts=starts,
        num_dst=num_dst,
        edge_src=list(reversed(rev_src)),
        edge_dst=list(reversed(rev_dst)),
        edge_mask=list(reversed(rev_mask)),
        edge_starts=list(reversed(rev_starts)))


# ---------------------------------------------------------------------------
# device remote-frequency counting + hot-set ordering
# ---------------------------------------------------------------------------

def _freq_step(r: torch.Tensor, *, span: int):
    m_pad = r.shape[0]
    num_bits = max(int(span - 1).bit_length(), 1)
    sk, _ = seg_sort(r, num_bits=num_bits)
    valid = sk != SENT
    head = _run_heads(sk)
    rank = _cumsum_i32(head) - 1
    nu = rank[-1:] + 1
    uk = _scatter_drop(m_pad, SENT, rank, sk, head)
    # run lengths: start index of each unique value, then boundary diff
    iota = torch.arange(m_pad, dtype=_I32, device=r.device)
    st = _scatter_drop(m_pad + 1, 0, rank, iota, head)
    st = st.scatter(0, torch.clamp(nu, max=m_pad).long(),
                    valid.to(_I32).sum(dtype=_I32).reshape(1))
    freq = torch.diff(st)
    return uk, freq, nu


def _hot_order(ids: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """ids by (freq desc, id asc): SENT-padded slots sort last (their
    sort key +1 exceeds every real ``-freq <= -1``). One stable sort of
    the int64 composite key ``(negf << 32) + id``, which orders as the
    pair does."""
    negf = torch.where(ids != SENT, -freq, torch.ones_like(freq))
    key = (negf.long() << 32) + ids.long()
    order = torch.sort(key, stable=True).indices
    return ids[order]


def device_remote_freq(remote: np.ndarray, span: int, *,
                       device: Optional[torch.device] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """``np.unique(remote, return_counts=True)`` as device ops (sort +
    run-length compaction). ``remote`` is the flat stream of remote
    input-node ids; ids are unique per batch, so run lengths ARE the
    per-batch indicator sums the paper's freq(.) wants."""
    if remote.size == 0 or span >= KEY_INT32_MAX_SLOTS:
        ids, freq = (np.unique(remote, return_counts=True)
                     if remote.size else (np.zeros(0, np.int64),) * 2)
        return ids.astype(np.int64), np.asarray(freq, np.int64)
    device = resolve_device(device)
    m_pad = _bucket(remote.size)
    uk, freq, nu = _freq_step(
        _pad_i32(remote.astype(np.int64), m_pad, device), span=span)
    k = int(nu.item())
    return (uk[:k].cpu().numpy().astype(np.int64),
            freq[:k].cpu().numpy().astype(np.int64))


def device_select_hot_set(remote_ids: np.ndarray, remote_freq: np.ndarray,
                          n_hot: int, *,
                          device: Optional[torch.device] = None
                          ) -> np.ndarray:
    """``core.schedule.select_hot_set`` with the (freq desc, id asc)
    ordering done by a device sort; the top-k slice and final ascending
    sort stay host-side (k <= n_hot rows)."""
    k = min(n_hot, remote_ids.shape[0])
    if k <= 0:
        return np.zeros(0, np.int64)
    if remote_ids.size and int(remote_ids.max()) >= SENT:
        from repro_torch.core.schedule import select_hot_set
        return select_hot_set(remote_ids, remote_freq, n_hot)
    device = resolve_device(device)
    m_pad = _bucket(remote_ids.shape[0])
    sid = _hot_order(_pad_i32(remote_ids, m_pad, device),
                     _pad_i32(remote_freq.astype(np.int32), m_pad, device,
                              fill=0))
    return np.sort(sid[:k].cpu().numpy().astype(np.int64))
