"""Deterministic K-hop neighbor sampler (paper §3, §4 components 1-3).

Seeds: ``s_{e,i}^{(w)} = H(s0, w, e, i)`` with H = BLAKE2b (a cryptographic
hash, exactly as the paper specifies). Distinct (w, e, i) tuples hash to
independent uniform 64-bit values seeding non-overlapping Philox streams,
which gives Proposition 3.1 (a)-(c): marginal law identical to an online
uniform draw, independence across tuples, unbiased gradients.

The sampler emits MFG-style blocks (DGL convention): for each GNN layer,
``dst`` nodes are a prefix of ``src`` nodes; edges are (src_idx, dst_idx)
pairs indexing the per-layer node arrays. Only METADATA is produced here
(ids / offsets / locality) -- features are materialized later by the
cache/prefetch machinery, mirroring the paper's sampler->prefetcher split.

Neighbors are drawn uniformly WITH replacement (fan-out F per node), which
keeps per-layer edge counts static (num_dst x F) -- the fan-out-regular
layout the ``gather_agg`` kernel reads -- while preserving the uniform
marginal Prop 3.1 relies on. Zero-degree nodes contribute masked edges.

This is the port's own copy of ``repro.graph.sampler``: the per-batch
sampler, the per-batch epoch loop (``sample_epoch``) and the whole-epoch
compiler (``sample_epoch_batched``). Its outputs are bit-identical to the
reference for the same seeds.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.graph.graph import Graph


def _starts(counts: np.ndarray) -> np.ndarray:
    """(k,) segment counts -> (k+1,) int64 exclusive-prefix offsets."""
    out = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=out[1:])
    return out


#: composite (batch, id) key spaces below this bound sort as int32
#: keys: numpy's stable sort on 32-bit integers is a radix sort, which
#: turns the segment-unique argsorts O(n) and cache-friendly. Larger
#: spaces fall back to int64 keys (same algorithm, comparison sort).
KEY_INT32_MAX_SLOTS = 2 ** 31


def derive_seed(s0: int, *fields: int) -> int:
    """H(s0, w, e, i, ...) -> uint64, H = BLAKE2b-8."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", s0))
    for f in fields:
        h.update(struct.pack("<q", int(f)))
    return struct.unpack("<Q", h.digest())[0]


def rng_from(s0: int, *fields: int) -> np.random.Generator:
    # repro: allow(RNG-CONTRACT) -- the port's copy of the one sanctioned Philox constructor; every stream is keyed H(s0, fields)
    return np.random.default_rng(np.random.Philox(derive_seed(s0, *fields)))


@dataclasses.dataclass
class Block:
    """One message-passing layer: edges src->dst.

    src nodes of the layer are ``input_nodes[:num_src]`` of the parent
    batch at that depth; dst nodes are the prefix ``[:num_dst]``.
    """
    num_src: int
    num_dst: int
    edge_src: np.ndarray     # (E,) int32 local idx into layer src array
    edge_dst: np.ndarray     # (E,) int32 local idx into layer dst array
    edge_mask: np.ndarray    # (E,) bool  False for zero-degree padding


@dataclasses.dataclass
class SampledBatch:
    epoch: int
    index: int
    worker: int
    seeds: np.ndarray         # (B,) int64 global ids (dst of last layer)
    input_nodes: np.ndarray   # (m,) int64 global ids, dst-prefix ordering
    blocks: List[Block]       # ordered input-layer -> output-layer

    @property
    def num_input_nodes(self) -> int:
        return int(self.input_nodes.shape[0])


@dataclasses.dataclass
class FlatEpoch:
    """One worker-epoch of sampled batches, packed CSR-style.

    The canonical schedule payload (DESIGN.md §2.1): every batch's
    seeds / input nodes / per-layer edges live in ONE flat array per
    field with ``(nb+1,)`` per-batch segment offsets, so whole-epoch
    consumers (frequency counting, device collation, npz spill) work on
    a handful of contiguous arrays instead of ``nb`` small ones. The
    legacy per-batch ``SampledBatch`` form is materialized lazily as
    zero-copy slice views (``batch``/``to_batches``) for the oracle and
    compat paths.

    Layer widths chain as in the MFG convention: layer ``l``'s src
    count is ``m_counts`` for ``l == 0`` and ``num_dst[l-1]`` above, so
    only ``num_dst`` is stored.
    """
    epoch: int
    worker: int
    seeds: np.ndarray               # (sum B_i,) int64 concatenated seeds
    seed_starts: np.ndarray         # (nb+1,) int64
    input_nodes: np.ndarray         # (sum m_i,) int64, dst-prefix order
    input_starts: np.ndarray        # (nb+1,) int64
    num_dst: np.ndarray             # (L, nb) int64 per-layer dst counts
    edge_src: List[np.ndarray]      # per layer: (sum E_l,) int32
    edge_dst: List[np.ndarray]      # per layer: (sum E_l,) int32
    edge_mask: List[np.ndarray]     # per layer: (sum E_l,) bool
    edge_starts: List[np.ndarray]   # per layer: (nb+1,) int64

    @property
    def num_batches(self) -> int:
        return int(self.seed_starts.shape[0] - 1)

    @property
    def num_layers(self) -> int:
        return int(self.num_dst.shape[0])

    @property
    def m_counts(self) -> np.ndarray:
        """(nb,) input-node count per batch."""
        return np.diff(self.input_starts)

    def num_src(self, l: int) -> np.ndarray:
        """(nb,) src-node count of layer ``l`` (width-chain identity)."""
        return self.m_counts if l == 0 else self.num_dst[l - 1]

    def batch(self, i: int) -> SampledBatch:
        """Materialize batch ``i`` as zero-copy views into the flat arrays."""
        s0, s1 = self.input_starts[i], self.input_starts[i + 1]
        blocks: List[Block] = []
        for l in range(self.num_layers):
            e0, e1 = self.edge_starts[l][i], self.edge_starts[l][i + 1]
            blocks.append(Block(
                num_src=int(s1 - s0) if l == 0
                else int(self.num_dst[l - 1, i]),
                num_dst=int(self.num_dst[l, i]),
                edge_src=self.edge_src[l][e0:e1],
                edge_dst=self.edge_dst[l][e0:e1],
                edge_mask=self.edge_mask[l][e0:e1]))
        return SampledBatch(
            epoch=self.epoch, index=i, worker=self.worker,
            seeds=self.seeds[self.seed_starts[i]:self.seed_starts[i + 1]],
            input_nodes=self.input_nodes[s0:s1], blocks=blocks)

    def to_batches(self) -> List[SampledBatch]:
        return [self.batch(i) for i in range(self.num_batches)]

    @staticmethod
    def empty(epoch: int, worker: int, num_layers: int) -> "FlatEpoch":
        z64 = np.zeros(0, np.int64)
        zs = np.zeros(1, np.int64)
        return FlatEpoch(
            epoch=epoch, worker=worker, seeds=z64, seed_starts=zs,
            input_nodes=z64.copy(), input_starts=zs.copy(),
            num_dst=np.zeros((num_layers, 0), np.int64),
            edge_src=[np.zeros(0, np.int32) for _ in range(num_layers)],
            edge_dst=[np.zeros(0, np.int32) for _ in range(num_layers)],
            edge_mask=[np.zeros(0, bool) for _ in range(num_layers)],
            edge_starts=[zs.copy() for _ in range(num_layers)])

    @staticmethod
    def from_batches(batches: Sequence[SampledBatch], epoch: int,
                     worker: int,
                     num_layers: Optional[int] = None) -> "FlatEpoch":
        """Pack per-batch samples into the flat layout (the inverse of
        ``to_batches``; round-trips bit-exactly)."""
        nb = len(batches)
        if nb == 0:
            return FlatEpoch.empty(epoch, worker, num_layers or 0)
        L = len(batches[0].blocks)
        seed_starts = _starts(np.fromiter(
            (b.seeds.shape[0] for b in batches), np.int64, nb))
        input_starts = _starts(np.fromiter(
            (b.num_input_nodes for b in batches), np.int64, nb))
        num_dst = np.array([[b.blocks[l].num_dst for b in batches]
                            for l in range(L)], np.int64).reshape(L, nb)
        return FlatEpoch(
            epoch=epoch, worker=worker,
            seeds=np.concatenate([b.seeds for b in batches]).astype(
                np.int64),
            seed_starts=seed_starts,
            input_nodes=np.concatenate(
                [b.input_nodes for b in batches]).astype(np.int64),
            input_starts=input_starts, num_dst=num_dst,
            edge_src=[np.concatenate([b.blocks[l].edge_src
                                      for b in batches]) for l in range(L)],
            edge_dst=[np.concatenate([b.blocks[l].edge_dst
                                      for b in batches]) for l in range(L)],
            edge_mask=[np.concatenate([b.blocks[l].edge_mask
                                       for b in batches]) for l in range(L)],
            edge_starts=[_starts(np.fromiter(
                (b.blocks[l].edge_src.shape[0] for b in batches),
                np.int64, nb)) for l in range(L)])


class KHopSampler:
    def __init__(self, graph: Graph, fanouts: Sequence[int],
                 batch_size: int):
        self.graph = graph
        self.fanouts = list(fanouts)     # fanouts[l] for layer l (input->output)
        self.batch_size = batch_size

    # ---- batch enumeration (deterministic shuffle per worker/epoch) ----
    def epoch_seed_batches(self, s0: int, worker: int, epoch: int,
                           train_nodes: np.ndarray) -> List[np.ndarray]:
        rng = rng_from(s0, worker, epoch, -1)   # i=-1 : the shuffle stream
        perm = rng.permutation(train_nodes)
        nb = int(np.ceil(perm.shape[0] / self.batch_size))
        return [perm[i * self.batch_size:(i + 1) * self.batch_size]
                for i in range(nb)]

    # ---- one batch ----
    def sample_batch(self, s0: int, worker: int, epoch: int, index: int,
                     seed_nodes: np.ndarray) -> SampledBatch:
        g = self.graph
        rng = rng_from(s0, worker, epoch, index)
        cur = np.asarray(seed_nodes, dtype=np.int64)
        blocks_rev: List[Block] = []
        # walk output layer -> input layer
        for fanout in reversed(self.fanouts):
            deg = (g.indptr[cur + 1] - g.indptr[cur]).astype(np.int64)
            nd = cur.shape[0]
            offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(nd, fanout))
            src_pos = g.indptr[cur][:, None] + offs
            src = g.indices[np.minimum(src_pos, g.num_edges - 1)].astype(np.int64)
            mask = np.broadcast_to((deg > 0)[:, None], (nd, fanout)).reshape(-1)
            src_flat = src.reshape(-1)
            dst_idx = np.repeat(np.arange(nd, dtype=np.int32), fanout)
            # masked (zero-degree) edges self-loop onto their dst so their
            # src id is always present in the node array
            src_flat = np.where(mask, src_flat, cur[dst_idx])

            # src node array = dst prefix + new unique sources
            uniq = np.unique(src_flat)
            extra = np.setdiff1d(uniq, cur, assume_unique=False)
            src_nodes = np.concatenate([cur, extra])
            sorter = np.argsort(src_nodes, kind="stable")
            src_idx = sorter[np.searchsorted(src_nodes, src_flat,
                                             sorter=sorter)].astype(np.int32)
            blocks_rev.append(Block(num_src=src_nodes.shape[0], num_dst=nd,
                                    edge_src=src_idx, edge_dst=dst_idx,
                                    edge_mask=mask))
            cur = src_nodes
        blocks = list(reversed(blocks_rev))
        return SampledBatch(epoch=epoch, index=index, worker=worker,
                            seeds=np.asarray(seed_nodes, dtype=np.int64),
                            input_nodes=cur, blocks=blocks)

    def sample_epoch(self, s0: int, worker: int, epoch: int,
                     train_nodes: np.ndarray) -> List[SampledBatch]:
        """Per-batch reference epoch sampler: one ``sample_batch`` call
        per batch. Kept as the parity oracle ``sample_epoch_batched`` is
        tested and benchmarked against (repo convention: the loop
        survives as the oracle of every vectorized pass)."""
        out = []
        for i, seeds in enumerate(
                self.epoch_seed_batches(s0, worker, epoch, train_nodes)):
            out.append(self.sample_batch(s0, worker, epoch, i, seeds))
        return out

    # ---- whole-epoch compiler (DESIGN.md §2.1) ----
    def sample_epoch_batched(self, s0: int, worker: int, epoch: int,
                             train_nodes: np.ndarray) -> FlatEpoch:
        """Sample a whole epoch in a handful of vectorized passes,
        BIT-IDENTICAL to ``sample_epoch`` (the hypothesis parity suite
        pins it batch-for-batch, array-for-array).

        All batches' frontiers ride one flat, batch-segmented stream:
        per layer there is ONE degree gather, ONE neighbor-table gather
        and ONE composite-key sort for the segment-aware unique /
        dst-prefix construction, replacing the per-batch
        ``unique``/``setdiff1d``/``argsort``/``searchsorted`` quartet.
        Only the offset draw stays per batch -- each batch owns an
        independent Philox stream seeded ``H(s0, w, e, i)`` (Prop 3.1
        demands it), so its draw is one blockwise ``Generator.integers``
        call on that stream, exactly the call ``sample_batch`` makes.

        This numpy path doubles as the ORACLE for the accelerator port
        (``graph.device_sampler.sample_epoch_batched_device``, DESIGN.md
        §2.2), which moves the sort-bound middle on device and must stay
        bit-identical to it.
        """
        g = self.graph
        L = len(self.fanouts)
        seed_batches = self.epoch_seed_batches(s0, worker, epoch,
                                               train_nodes)
        nb = len(seed_batches)
        if nb == 0:
            return FlatEpoch.empty(epoch, worker, L)
        seeds_flat = np.concatenate(seed_batches).astype(np.int64)
        seed_counts = np.fromiter((b.shape[0] for b in seed_batches),
                                  np.int64, nb)
        seed_starts = _starts(seed_counts)
        rngs = [rng_from(s0, worker, epoch, i) for i in range(nb)]
        span = np.int64(g.num_nodes)

        cur = seeds_flat                 # flat frontier, batch-segmented
        counts, starts = seed_counts, seed_starts
        num_dst = np.zeros((L, nb), np.int64)
        rev_src: List[np.ndarray] = []
        rev_dst: List[np.ndarray] = []
        rev_mask: List[np.ndarray] = []
        rev_starts: List[np.ndarray] = []

        # int32 composite keys whenever the key space allows: the
        # per-layer segment-unique argsorts are memory-bound at epoch
        # scale, and halving the key width buys ~1.6x there
        kdt = (np.int32 if nb * int(span) < KEY_INT32_MAX_SLOTS
               else np.int64)
        span_k = kdt(span)
        bids = np.arange(nb, dtype=kdt)

        # walk output layer -> input layer, as sample_batch does
        for j, fanout in enumerate(reversed(self.fanouts)):
            num_dst[L - 1 - j] = counts
            batch_of = np.repeat(bids, counts)
            within = np.arange(cur.shape[0], dtype=np.int64) \
                - starts[batch_of]
            deg = (g.indptr[cur + 1] - g.indptr[cur]).astype(np.int64)
            hi = np.maximum(deg, 1)
            offs = np.empty((cur.shape[0], fanout), np.int64)
            for i in range(nb):     # one blockwise draw per Philox stream
                sl = slice(starts[i], starts[i + 1])
                offs[sl] = rngs[i].integers(
                    0, hi[sl][:, None], size=(int(counts[i]), fanout))
            src_pos = g.indptr[cur][:, None] + offs
            zero = np.flatnonzero(deg == 0)
            if zero.size:       # only deg-0 rows can index past the end
                src_pos[zero] = 0
            src_flat = g.indices[src_pos].reshape(-1) \
                .astype(kdt, copy=False)
            mask = np.repeat(deg > 0, fanout)
            if zero.size:
                # masked (zero-degree) edges self-loop onto their dst:
                # patch just those slots (edge e <- frontier row e // F)
                bad = np.flatnonzero(~mask)
                src_flat[bad] = cur[bad // fanout]

            dst_idx = np.repeat(within, fanout).astype(np.int32)
            ecount = counts * fanout
            cand_key = np.repeat(bids, ecount) * span_k + src_flat

            # segment-aware unique: composite (batch, id) keys make one
            # global sort act per batch (keys never cross segments);
            # the inverse indices replace every per-batch searchsorted
            uk, inv = np.unique(cand_key, return_inverse=True)

            cur_key = (batch_of * span_k
                       + cur.astype(kdt, copy=False))
            csort = np.argsort(cur_key)
            cks = cur_key[csort]
            pos = np.minimum(np.searchsorted(cks, uk),
                             cks.shape[0] - 1)
            is_new = cks[pos] != uk
            ext_key = uk[is_new]
            ext_batch = (ext_key // span_k).astype(np.int64)
            ext_id = (ext_key - ext_batch * span_k).astype(np.int64)
            ext_counts = np.bincount(ext_batch, minlength=nb) \
                .astype(np.int64)
            ext_starts = _starts(ext_counts)
            ewithin = np.arange(ext_id.shape[0], dtype=np.int64) \
                - ext_starts[ext_batch]

            # next frontier: dst prefix then the new unique sources
            # (ascending per batch == the setdiff1d contract)
            new_counts = counts + ext_counts
            new_starts = _starts(new_counts)
            new_cur = np.empty(int(new_starts[-1]), np.int64)
            new_cur[new_starts[batch_of] + within] = cur
            new_cur[new_starts[ext_batch] + counts[ext_batch]
                    + ewithin] = ext_id

            # resolve each UNIQUE key once (old keys sit at their
            # dst-prefix position, new keys at prefix + extra rank),
            # then fan out to edges through the unique-inverse -- no
            # edge-sized searchsorted ever runs
            uk_local = np.empty(uk.shape[0], np.int64)
            uk_local[~is_new] = within[csort[pos[~is_new]]]
            uk_local[is_new] = counts[ext_batch] + ewithin
            src_idx = uk_local[inv].astype(np.int32)

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
