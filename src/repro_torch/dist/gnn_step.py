"""The device-distributed RapidGNN epoch over a flat ``("data",)`` or
hierarchical ``("dcn", "data")`` worker mesh, the port of
``repro/dist/gnn_step.py``.

The reference expresses Alg. 1's prefetcher/trainer overlap inside one
compiled program: a ``jax.lax.scan`` over the S steps of an epoch whose
body (a) issues the all-to-all residual-miss pull for step i+1 and (b)
trains on step i's already-pulled features, on a mesh of P devices. The
port holds the P workers in one process on one device
(``dist.mesh.Mesh``) and writes the scan as a Python loop: step i+1's
pull (``feature_a2a.pull_features``) is issued on a side CUDA stream
while step i trains on the default stream, into the other of two
pulled-feature buffers, with the streams ordered both ways (the side
stream waits for the default stream's last read of the buffer it
overwrites; the default stream waits for the pull before it reads the
buffer). On the CPU the same order runs on one stream. A hierarchical
``topology`` switches the pull to the two-tier exchange
(``feature_a2a.pull_features_two_tier``), bit-equal to the flat one.

Each step assembles every worker's features (``kernels/assemble``,
backend ``auto|fused|ref|staged``: local shard > C_s > pulled), trains
every worker's batch with ``models.gnn.loss_and_grads`` (the
``gather_agg`` forward and backward kernels on the card), averages
gradients, loss and accuracy over the workers as the reference's
``pmean`` does (a sum in worker order, then a division by P), and takes
one optimizer step on the single parameter copy the in-process workers
share.

Host-side companions (numpy, copied from the reference and pinned to it
bit for bit by the tests): ``DeviceView`` relabels the partitioned graph
into contiguous per-worker slot ranges so ownership is ``id // n_per``;
``epoch_k_max`` computes the exact static lane bound;
``collate_device_epoch`` packs a whole epoch into (S, P, ...) arrays in
one vectorised pass (``collate_device_epoch_loop`` is its per-(step,
worker) oracle), with two-tier lanes on a hierarchical topology
(``epoch_k_max_split`` gives their bounds); ``stack_caches`` stacks the
per-worker hot sets C_s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.schedule import EpochSchedule, collate
from repro_torch.dist.feature_a2a import (build_pull_plan, pack_pull_lanes,
                                          pack_pull_lanes_two_tier,
                                          pull_features,
                                          pull_features_two_tier,
                                          pull_shard)
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.kernels.assemble.ops import assemble_features
from repro_torch.kernels.cache_lookup.ops import to_device_ids
from repro_torch.models.gnn import GNNConfig, loss_and_grads
from repro_torch.train.optim import tree_leaves, tree_map

#: pull-plan keys of the collated epoch dict, per topology tier layout
PULL_KEYS_FLAT = ("send_ids", "send_pos", "send_mask")
PULL_KEYS_HIER = ("intra_ids", "intra_pos", "intra_mask",
                  "inter_ids", "inter_pos", "inter_mask")

#: int64 cache padding; survives the int32 cast exactly and matches the
#: ``search`` kernel's sentinel (``kernels/cache_lookup``).
CACHE_PAD = int(2 ** 31 - 1)


@dataclasses.dataclass
class DeviceCache:
    """One worker's hot set C_s in DEVICE id space, sorted for searchsorted."""
    ids: np.ndarray      # (k,) int64 device ids, sorted unique
    feats: np.ndarray    # (k, d) float32


@dataclasses.dataclass
class DeviceView:
    """Device relabeling of a PartitionedGraph.

    Partitions own arbitrary global-id sets; the device path needs
    ownership decidable by arithmetic (``owner = id // n_per``) so the
    pull can turn an id into (owner, slot) with no lookup table on
    device. ``build`` assigns worker p's nodes the dense device ids
    ``p * n_per + [0..|V_p|)`` with ``n_per = max_p |V_p|`` (tail slots
    of smaller partitions are zero rows, never referenced).
    """
    num_parts: int
    n_per: int
    table: np.ndarray      # (P, n_per, d) float32, partition-sharded rows
    offsets: np.ndarray    # (P, 1) int32   first device slot per worker
    g2d: np.ndarray        # (n,) int64     global id -> device id
    features: np.ndarray   # (n, d)         global table (host ref, not copied)

    @staticmethod
    def build(pg: PartitionedGraph) -> "DeviceView":
        g = pg.graph
        P_ = pg.num_parts
        n_per = int(max(ln.shape[0] for ln in pg.local_nodes))
        table = np.zeros((P_, n_per, g.feat_dim), np.float32)
        g2d = np.empty(g.num_nodes, np.int64)
        for p, loc in enumerate(pg.local_nodes):
            table[p, : loc.shape[0]] = g.features[loc]
            g2d[loc] = p * n_per + np.arange(loc.shape[0], dtype=np.int64)
        offsets = (np.arange(P_, dtype=np.int32) * n_per)[:, None]
        return DeviceView(num_parts=P_, n_per=n_per, table=table,
                          offsets=offsets, g2d=g2d, features=g.features)

    @property
    def owner_d(self) -> np.ndarray:
        """(P*n_per,) device-id -> owner, for build_pull_plan."""
        return np.repeat(np.arange(self.num_parts, dtype=np.int32),
                         self.n_per)

    def remap_cache(self, cache_ids_global: np.ndarray) -> DeviceCache:
        """Global hot-set ids (schedule output) -> sorted device cache."""
        dev = self.g2d[cache_ids_global]
        order = np.argsort(dev)
        return DeviceCache(
            ids=dev[order],
            feats=self.features[cache_ids_global[order]].astype(np.float32))


def _batch_miss(es_batch, cache: DeviceCache, dv: DeviceView, worker: int):
    """-> (dev_ids (m,), miss_mask (m,)) for one sampled batch."""
    dev = dv.g2d[es_batch.input_nodes]
    remote = (dev // dv.n_per) != worker
    miss = remote & ~np.isin(dev, cache.ids, assume_unique=False)
    return dev, miss


def _epoch_flat(es_list: Sequence[EpochSchedule], dv: DeviceView
                ) -> Optional[Dict[str, np.ndarray]]:
    """Splice the P workers' FlatEpoch payloads into one worker-major
    batch stream with ONE ``g2d`` gather (the vectorized staging spine,
    DESIGN.md §6.6). Since the schedule compiler already stores each
    worker-epoch flat (CSR offsets, no per-batch objects), this is P
    concatenations -- the per-(worker, batch) rec loop is gone.

    -> dict: the per-worker ``flats`` plus per-batch ``step``/``worker``
    /``m_counts``/``starts`` (element offsets) and the per-element
    ``dev`` device ids; None for an epoch with no batches at all.
    Per-element batch/column coordinates are NOT materialized here --
    ``_miss_coords`` derives them lazily for just the miss subset.
    """
    flats = [es.flat for es in es_list]
    nbs = np.fromiter((f.num_batches for f in flats), np.int64,
                      len(flats))
    n = int(nbs.sum())
    if n == 0:
        return None
    step = np.concatenate([np.arange(nb, dtype=np.int64) for nb in nbs])
    worker = np.repeat(np.arange(len(flats), dtype=np.int64), nbs)
    m_counts = np.concatenate([f.m_counts for f in flats])
    dev = dv.g2d[np.concatenate([f.input_nodes for f in flats])]
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(m_counts, out=starts[1:])
    return {"flats": flats, "step": step, "worker": worker,
            "m_counts": m_counts, "dev": dev, "starts": starts}


def _miss_coords(flat: Dict[str, np.ndarray], miss: np.ndarray):
    """(batch ordinal, buffer row) of each missed element, derived from
    the element offsets -- a binary search over the (n_batches,) starts
    vector on just the miss subset instead of materializing full
    per-element repeat/arange coordinate arrays."""
    idx = np.flatnonzero(miss)
    eb = np.searchsorted(flat["starts"], idx, side="right") - 1
    return eb, idx - flat["starts"][eb]


#: device-id spaces up to this many slots use the O(1) stamp-table
#: membership test (int32 stamp array = 4 bytes/slot host scratch);
#: larger spaces fall back to per-worker binary search
STAMP_TABLE_MAX_SLOTS = 1 << 26


def _classify_misses(flat: Dict[str, np.ndarray],
                     caches: Sequence[DeviceCache], dv: DeviceView):
    """Residual-miss classification for a whole epoch in one vectorized
    pass per worker (replacing the S x P per-batch ``np.isin`` calls,
    each of which re-sorted the hot set).

    The flattened element stream is worker-major, so each worker's
    elements are one contiguous slice. Membership in that worker's hot
    set is an O(1) probe of a slot-indexed STAMP table (``stamp[id] ==
    w``; workers stamp in ascending order, so later overwrites never
    corrupt earlier queries and the table needs no clearing) -- for id
    spaces too large for the 4 B/slot scratch it degrades to one
    vectorized binary search per worker against its cache-resident
    (n_hot,) key vector. Remoteness is two compares against the
    worker's slot range, not a division.

    -> (miss mask aligned with ``flat['dev']``, owners of just the
    missed elements).
    """
    dev = flat["dev"]
    miss = np.zeros(dev.shape, bool)
    wk, mc = flat["worker"], flat["m_counts"]
    n_slots = dv.num_parts * dv.n_per
    stamp = (np.full(n_slots, -1, np.int32)
             if n_slots <= STAMP_TABLE_MAX_SLOTS else None)
    lo = 0
    for w, cache in enumerate(caches):
        span = int(mc[wk == w].sum())
        sl = slice(lo, lo + span)
        lo += span
        if span == 0:
            continue
        d = dev[sl]
        base = w * dv.n_per
        rem = (d < base) | (d >= base + dv.n_per)
        if cache.ids.shape[0] == 0 or not rem.any():
            miss[sl] = rem
            continue
        q = d[rem]
        m = rem.copy()
        if stamp is not None:
            stamp[cache.ids] = w
            m[rem] = stamp[q] != w
        else:
            pos = np.minimum(np.searchsorted(cache.ids, q),
                             cache.ids.shape[0] - 1)
            m[rem] = cache.ids[pos] != q
        miss[sl] = m
    return miss, dev[miss] // dv.n_per


def epoch_k_max(es_list: Sequence[EpochSchedule],
                caches: Sequence[DeviceCache], dv: DeviceView) -> int:
    """Exact static per-owner lane bound over all (worker, step) pairs,
    computed in one vectorized pass over the whole epoch (bincount over
    (batch, owner) group keys -- no per-batch loop).

    Pad bounds (m_max / edge maxima) are NOT recomputed here -- callers
    precompute them once via ``WorkerSchedule.pad_bounds()`` (the
    multi-epoch runner maxes this over every epoch's caches so all
    epochs share one compiled program). Workers with fewer batches
    simply contribute fewer (worker, step) pairs."""
    flat = _epoch_flat(es_list, dv)
    if flat is None:
        return 1
    miss, owner_miss = _classify_misses(flat, caches, dv)
    if owner_miss.size == 0:
        return 1
    P_ = len(es_list)
    eb, _ = _miss_coords(flat, miss)
    return max(1, int(np.bincount(eb * P_ + owner_miss).max()))


def epoch_k_max_split(es_list: Sequence[EpochSchedule],
                      caches: Sequence[DeviceCache], dv: DeviceView,
                      topo) -> tuple:
    """Exact static lane bounds for the TWO-TIER plan: ``(k_max_intra,
    k_max_inter)`` over all (worker, step) pairs of the epoch, split by
    whether the missed id's owner shares the requesting worker's host
    (same vectorized bincount pass as ``epoch_k_max``, one group key
    per tier). Both bounds floor at 1 so degenerate tiers (single-host
    epochs, all-local epochs) still give static shapes."""
    flat = _epoch_flat(es_list, dv)
    if flat is None:
        return 1, 1
    miss, owner_miss = _classify_misses(flat, caches, dv)
    if owner_miss.size == 0:
        return 1, 1
    P_ = len(es_list)
    D = topo.devices_per_host
    eb, _ = _miss_coords(flat, miss)
    req = flat["worker"][eb]
    same = topo.same_host(owner_miss, req)
    k_i = k_x = 1
    if same.any():
        k_i = int(np.bincount(
            eb[same] * D + topo.local_of(owner_miss[same])).max())
    if (~same).any():
        k_x = int(np.bincount(eb[~same] * P_ + owner_miss[~same]).max())
    return max(1, k_i), max(1, k_x)


def _hier(topology) -> bool:
    return topology is not None and topology.is_hierarchical


def _alloc_epoch(P_: int, S: int, batch_size: int, m_max: int,
                 edge_max: Sequence[int], k_max: int, topology=None,
                 k_max_inter: Optional[int] = None
                 ) -> Dict[str, np.ndarray]:
    """Empty (S, P, ...) device-layout epoch: every step fully masked.
    With a hierarchical ``topology`` the pull lanes split into the
    two-tier layout -- intra (S, P, D, k_max) + inter (S, P, P,
    k_max_inter) -- instead of the flat send_* (S, P, P, k_max)."""
    out = {
        "input_nodes": np.full((S, P_, m_max), -1, np.int64),
        "labels": np.zeros((S, P_, batch_size), np.int32),
        "seed_mask": np.zeros((S, P_, batch_size), bool),
        "edge_src": [np.zeros((S, P_, e), np.int32) for e in edge_max],
        "edge_dst": [np.zeros((S, P_, e), np.int32) for e in edge_max],
        "edge_mask": [np.zeros((S, P_, e), bool) for e in edge_max],
    }
    if _hier(topology):
        D = topology.devices_per_host
        k_x = k_max_inter if k_max_inter is not None else k_max
        for tier, G, k in (("intra", D, k_max), ("inter", P_, k_x)):
            out[f"{tier}_ids"] = np.zeros((S, P_, G, k), np.int32)
            out[f"{tier}_pos"] = np.zeros((S, P_, G, k), np.int32)
            out[f"{tier}_mask"] = np.zeros((S, P_, G, k), bool)
    else:
        out["send_ids"] = np.zeros((S, P_, P_, k_max), np.int32)
        out["send_pos"] = np.zeros((S, P_, P_, k_max), np.int32)
        out["send_mask"] = np.zeros((S, P_, P_, k_max), bool)
    return out


def _check_num_steps(es_list: Sequence[EpochSchedule], S: int) -> None:
    over = [w for w, es in enumerate(es_list) if es.num_batches > S]
    if over:
        raise ValueError(
            f"workers {over} have more batches than num_steps={S}; "
            f"pass num_steps >= max worker batch count "
            f"(dropping steps would corrupt miss accounting)")


def collate_device_epoch(es_list: Sequence[EpochSchedule],
                         caches: Sequence[DeviceCache], dv: DeviceView,
                         labels: np.ndarray, batch_size: int, m_max: int,
                         edge_max: Sequence[int], k_max: int,
                         num_steps: int, topology=None,
                         k_max_inter: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
    """Pack an epoch into the (S, P, ...) device layout -- vectorised.

    Per (step, worker): the padded collated batch (ids remapped to
    device space, -1 padded) plus the residual-miss PullPlan lanes,
    batch-for-batch identical to ``collate_device_epoch_loop``. One
    ``g2d`` gather over every input node, one label gather over every
    seed, one stamp-table membership pass per worker
    (``_classify_misses``), one sort-based lane packing
    (``pack_pull_lanes``) and one boolean-mask slab fill per (worker,
    output array).

    ``m_max``/``edge_max``/``k_max``/``num_steps`` are precomputed
    bounds. A worker with fewer than ``num_steps`` batches gets fully
    masked empty steps for the tail: ids -1, all masks False, so it
    still takes part in every exchange but trains on nothing. Raises
    when a worker has MORE batches than ``num_steps`` (silent truncation
    would corrupt the fetch accounting).

    With a hierarchical ``topology`` the pull lanes come out two-tier
    (``intra_*``/``inter_*`` via ``pack_pull_lanes_two_tier``, bounds
    ``k_max``/``k_max_inter``) instead of flat ``send_*`` -- everything
    else (batches, labels, edges) is layout-identical.
    """
    P_ = len(es_list)
    S = num_steps
    _check_num_steps(es_list, S)
    out = _alloc_epoch(P_, S, batch_size, m_max, edge_max, k_max,
                       topology=topology, k_max_inter=k_max_inter)
    flat = _epoch_flat(es_list, dv)
    if flat is None:
        return out
    flats = flat["flats"]
    row = flat["step"] * P_ + flat["worker"]    # batch -> flat (step, w)
    dev = flat["dev"]

    # ragged padded fills: per worker slab, ONE boolean-mask assignment
    # per output array. The mask `arange(K) < counts[:, None]` iterates
    # the (S, K) slab in C order, which is exactly the worker's flat
    # stream order, so `slab[valid] = stream` is one sequential copy
    def _pad_counts(cnts: np.ndarray) -> np.ndarray:
        full = np.zeros(S, np.int64)
        full[:cnts.shape[0]] = cnts
        return full

    lo = 0
    for w, f in enumerate(flats):
        if f.num_batches == 0:
            continue    # fully masked worker; may carry 0 layer info
        span = int(f.input_starts[-1])
        valid = np.arange(m_max) < _pad_counts(f.m_counts)[:, None]
        out["input_nodes"][:, w][valid] = dev[lo:lo + span]
        lo += span
        svalid = np.arange(batch_size) < \
            _pad_counts(np.diff(f.seed_starts))[:, None]
        out["labels"][:, w][svalid] = labels[f.seeds]
        out["seed_mask"][:, w][svalid] = True
        for l in range(len(edge_max)):
            evalid = np.arange(edge_max[l]) < \
                _pad_counts(np.diff(f.edge_starts[l]))[:, None]
            out["edge_src"][l][:, w][evalid] = f.edge_src[l]
            out["edge_dst"][l][:, w][evalid] = f.edge_dst[l]
            out["edge_mask"][l][:, w][evalid] = f.edge_mask[l]

    # residual-miss pull lanes: one classification + one batched packing
    miss, owner_miss = _classify_misses(flat, caches, dv)
    eb, col = _miss_coords(flat, miss)
    # assume_unique: the sampler dedupes input_nodes per batch, so no
    # (group, id, pos) duplicates can exist
    if _hier(topology):
        D = topology.devices_per_host
        k_x = k_max_inter if k_max_inter is not None else k_max
        tiers = pack_pull_lanes_two_tier(
            dev[miss], col, row[eb], owner_miss, flat["worker"][eb],
            S * P_, topology, k_max, k_x, assume_unique=True)
        for tier, lanes, G, k in zip(("intra", "inter"), tiers, (D, P_),
                                     (k_max, k_x)):
            for key, a in zip(("ids", "pos", "mask"), lanes):
                out[f"{tier}_{key}"] = a.reshape(S, P_, G, k)
        return out
    sids, spos, smask, _ = pack_pull_lanes(
        dev[miss], col, row[eb], owner_miss, S * P_, P_, k_max,
        assume_unique=True)
    out["send_ids"] = sids.reshape(S, P_, P_, k_max)
    out["send_pos"] = spos.reshape(S, P_, P_, k_max)
    out["send_mask"] = smask.reshape(S, P_, P_, k_max)
    return out


def collate_device_epoch_loop(es_list: Sequence[EpochSchedule],
                              caches: Sequence[DeviceCache],
                              dv: DeviceView, labels: np.ndarray,
                              batch_size: int, m_max: int,
                              edge_max: Sequence[int], k_max: int,
                              num_steps: int) -> Dict[str, np.ndarray]:
    """Per-(step, worker) reference collation: one ``collate`` +
    ``build_pull_plan`` call per batch. Kept as the oracle the
    vectorized ``collate_device_epoch`` is parity-tested against."""
    P_ = len(es_list)
    S = num_steps
    L = len(edge_max)
    _check_num_steps(es_list, S)
    out = _alloc_epoch(P_, S, batch_size, m_max, edge_max, k_max)
    owner_d = dv.owner_d
    for w, es in enumerate(es_list):
        for i in range(len(es.batches)):
            b = es.batches[i]
            cb = collate(b, labels, batch_size, m_max, edge_max)
            dev, miss = _batch_miss(b, caches[w], dv, w)
            m = b.num_input_nodes
            out["input_nodes"][i, w, :m] = dev
            out["labels"][i, w] = cb.labels
            out["seed_mask"][i, w] = cb.seed_mask
            plan = build_pull_plan(dev[miss].astype(np.int32),
                                   np.flatnonzero(miss).astype(np.int32),
                                   owner_d, P_, k_max)
            out["send_ids"][i, w] = plan.send_ids
            out["send_pos"][i, w] = plan.send_pos
            out["send_mask"][i, w] = plan.send_mask
            for l in range(L):
                out["edge_src"][l][i, w] = cb.edge_src[l]
                out["edge_dst"][l][i, w] = cb.edge_dst[l]
                out["edge_mask"][l][i, w] = cb.edge_mask[l]
    return out


def stack_caches(caches: Sequence[DeviceCache], dv: DeviceView,
                 n_hot: int):
    """Stack per-worker hot sets into (P, n_hot) ids + (P, n_hot, d) rows.

    Ids stay sorted with CACHE_PAD tail padding (the device sentinel), so
    the binary-search ``cache_lookup`` works shard-locally unchanged.
    Raises when a cache exceeds ``n_hot``: the collation already routed
    those ids through C_s, so dropping them here would silently train on
    zero feature rows (same contract as build_pull_plan's overflow).
    """
    P_ = len(caches)
    d = dv.table.shape[-1]
    cids = np.full((P_, n_hot), CACHE_PAD, np.int64)
    cfeats = np.zeros((P_, n_hot, d), np.float32)
    for w, c in enumerate(caches):
        k = c.ids.shape[0]
        if k > n_hot:
            raise ValueError(
                f"worker {w} hot set has {k} ids > n_hot={n_hot}; "
                f"truncating would serve zero rows for ids the pull "
                f"plans treat as cache hits")
        cids[w, :k] = c.ids
        cfeats[w, :k] = c.feats
    return cids, cfeats


def prefetch_stream(send: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Roll the per-step pull plans one step forward (step i pulls step
    i+1's misses) and fully MASK the final element: the roll wraps step
    0's plan to the last step, whose pull would be discarded. The port's
    epoch loop skips that dead pull altogether (a Python loop, unlike the
    reference's scan, need not keep a static body); lane accounting comes
    from the un-rolled host arrays either way.

    send: dict of (S, ...) tensors -- the flat ``send_*`` triplet or the
    two-tier ``intra_*``/``inter_*`` sextet; keys ending in ``mask`` are
    AND-masked, the rest zeroed on the dead final element.
    """
    S = next(iter(send.values())).shape[0]
    out = {}
    for key, a in send.items():
        rolled = torch.roll(a, -1, dims=0)
        live = (torch.arange(S, device=a.device) < S - 1).reshape(
            (S,) + (1,) * (a.dim() - 1))
        out[key] = (rolled & live if key.endswith("mask")
                    else torch.where(live, rolled, torch.zeros_like(rolled)))
    return out


def tree_to_device(tree: Any, device: torch.device) -> Any:
    """numpy arrays / tensors (in dicts and lists) -> tensors on
    ``device``; tensors already there are passed through."""
    if isinstance(tree, dict):
        return {k: tree_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_device(v, device) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree)).to(device)
    return tree.to(device)


def _worker_batch(x: Dict[str, Any], w: int, feats: torch.Tensor
                  ) -> Dict[str, Any]:
    return {"features": feats,
            "edge_src": [e[w] for e in x["edge_src"]],
            "edge_dst": [e[w] for e in x["edge_dst"]],
            "edge_mask": [e[w] for e in x["edge_mask"]],
            "labels": x["labels"][w], "seed_mask": x["seed_mask"][w]}


def _pmean_train_step(cfg: GNNConfig, opt, params, opt_state,
                      feats: Sequence[torch.Tensor], x: Dict[str, Any]):
    """Shared step tail of both epoch programs: every worker's batch
    loss and gradients, averaged over the P workers as the reference's
    ``pmean`` (a sum in worker order, then a division by P), then one
    optimizer update of the shared parameters.
    -> (params, opt_state, loss, acc)."""
    P_ = len(feats)
    loss = acc = grads = None
    with trace.span("step.forward_backward"):
        for w in range(P_):
            l, a, g = loss_and_grads(cfg, params,
                                     _worker_batch(x, w, feats[w]))
            if grads is None:
                loss, acc, grads = l, a, g
            else:
                loss, acc = loss + l, acc + a
                grads = tree_map(torch.add, grads, g)
        grads = tree_map(lambda t: t / P_, grads)
    with trace.span("step.optimizer"):
        p2, o2 = opt.update(grads, opt_state, params)
    return p2, o2, loss / P_, acc / P_


def _step_inputs(bt: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Step i's (P, ...) training inputs from the (S, P, ...) epoch."""
    return {"labels": bt["labels"][i], "seed_mask": bt["seed_mask"][i],
            "edge_src": [e[i] for e in bt["edge_src"]],
            "edge_dst": [e[i] for e in bt["edge_dst"]],
            "edge_mask": [e[i] for e in bt["edge_mask"]]}


def _exchange(mesh, m_max: int, topology):
    """-> (the pull-plan keys of a collated epoch, ``pull(table,
    offsets, plan, i, out=None)``: step i's exchange of all workers) for
    ``topology`` -- the flat ``pull_features`` or, hierarchical, the
    two-tier ``pull_features_two_tier`` over ``mesh``'s host split."""
    if not _hier(topology):
        def pull(table, offsets, plan, i, out=None):
            return pull_features(mesh, table, plan["send_ids"][i],
                                 plan["send_pos"][i], plan["send_mask"][i],
                                 offsets, m_max, out=out)
        return PULL_KEYS_FLAT, pull
    if (mesh.hosts, mesh.num_workers) != (topology.hosts,
                                          topology.num_workers):
        raise ValueError(f"topology {topology.describe()} on a mesh of "
                         f"{mesh.hosts} hosts x {mesh.devices_per_host}")

    def pull_hier(table, offsets, plan, i, out=None):
        return pull_features_two_tier(
            mesh, table, {k: plan[k][i] for k in PULL_KEYS_HIER}, offsets,
            m_max, out=out)
    return PULL_KEYS_HIER, pull_hier


def make_pipelined_epoch(cfg: GNNConfig, opt, mesh, m_max: int,
                         assemble_backend: str = "auto",
                         topology=None):
    """-> epoch_fn(params, opt_state, table, offsets, cache_ids,
    cache_feats, batches) running S pipelined steps of all P workers on
    ``mesh``'s device. Returns (params, opt_state, losses (S,), accs
    (S,)).

    table (P, n_per, d); offsets (P,) or (P, 1); cache_ids (P, n_hot)
    sorted (CACHE_PAD padded); cache_feats (P, n_hot, d); batches the
    ``collate_device_epoch`` dict. numpy arrays are copied to the
    device; tensors already there are used as they are.

    Per step: step i+1's residual misses are pulled (on a side CUDA
    stream on the card) while step i trains on its own pulled buffer,
    assembled per worker by ``assemble_backend`` (local shard > C_s >
    pulled); gradients, loss and accuracy are averaged over the
    workers. The last step's prefetch (the masked wrap of
    ``prefetch_stream``) is not issued. A hierarchical ``topology``
    switches the pull to the two-tier exchange: bit-equal curves.

    With the tracer on (``repro_torch.core.trace``) the host's part is
    recorded: ``epoch.prologue`` up to the first pull, then one
    ``epoch.step`` a step around ``step.exchange`` (the next pull's
    launch; empty on the last step), ``step.assemble``,
    ``step.forward_backward`` and ``step.optimizer``.
    """
    pull_keys, exchange = _exchange(mesh, m_max, topology)
    device = mesh.device

    def epoch_fn(params, opt_state, table, offsets, cache_ids, cache_feats,
                 batches):
        def pull(plan, i, out):
            return exchange(table, offsets, plan, i, out=out)

        with trace.span("epoch.prologue"):
            table, offsets, cache_ids, cache_feats, bt = tree_to_device(
                [table, offsets, cache_ids, cache_feats, batches], device)
            P_, _, d = table.shape
            bases = [int(b) for b in offsets.reshape(-1).tolist()]
            cids32 = to_device_ids(cache_ids)           # (P, n_hot) int32
            query = to_device_ids(bt["input_nodes"])    # (S, P, m_max)
            send = {k: bt[k] for k in pull_keys}
            nxt_send = prefetch_stream(send)
            S = query.shape[0]
            # two pulled-feature buffers: step i reads bufs[i % 2] while
            # step i+1's pull writes the other
            bufs = [torch.empty((P_, m_max, d), dtype=table.dtype,
                                device=device) for _ in range(2)]
            side = (torch.cuda.Stream(device=device)
                    if device.type == "cuda" else None)
            pull(send, 0, bufs[0])
        losses, accs = [], []
        for i in range(S):
            with trace.span("epoch.step", step=i):
                pulled = bufs[i % 2]
                with trace.span("step.exchange"):  # empty on the last step
                    if i + 1 < S and side is None:
                        pull(nxt_send, i, bufs[(i + 1) % 2])
                    elif i + 1 < S:
                        # the buffer's last reader (step i-1's assembly)
                        # and every input of the pull precede it on this
                        # stream
                        side.wait_stream(torch.cuda.current_stream(device))
                        with torch.cuda.stream(side):
                            pull(nxt_send, i, bufs[(i + 1) % 2])
                with trace.span("step.assemble"):
                    feats = [assemble_features(
                        table[w], bases[w], cids32[w], cache_feats[w],
                        query[i, w], pulled[w], backend=assemble_backend)
                        for w in range(P_)]
                params, opt_state, loss, acc = _pmean_train_step(
                    cfg, opt, params, opt_state, feats, _step_inputs(bt, i))
                losses.append(loss)
                accs.append(acc)
                if side is not None:
                    # step i+1 reads the buffer the side stream just wrote
                    torch.cuda.current_stream(device).wait_stream(side)
        return params, opt_state, torch.stack(losses), torch.stack(accs)

    return epoch_fn


def make_ondemand_epoch(cfg: GNNConfig, opt, mesh, m_max: int,
                        assemble_backend: str = "auto",
                        topology=None):
    """-> epoch_fn(params, opt_state, table, offsets, batches): the
    DGL-style on-demand baseline, NOT overlapped.

    Same mesh, same pull-plan wire format, same train step and the same
    assembly as ``make_pipelined_epoch`` (cache-less: local shard >
    pulled), but step i's pull feeds step i's own features, so the
    exchange sits on the trainer's critical path every step. Collate its
    batches with EMPTY caches so every remote id rides the pull lanes.
    A hierarchical ``topology`` switches pulls to the two-tier exchange,
    as in ``make_pipelined_epoch``.
    """
    _, exchange = _exchange(mesh, m_max, topology)
    device = mesh.device

    def epoch_fn(params, opt_state, table, offsets, batches):
        with trace.span("epoch.prologue"):
            table, offsets, bt = tree_to_device([table, offsets, batches],
                                                device)
            P_ = table.shape[0]
            bases = [int(b) for b in offsets.reshape(-1).tolist()]
            query = to_device_ids(bt["input_nodes"])
        losses, accs = [], []
        for i in range(query.shape[0]):
            with trace.span("epoch.step", step=i):
                with trace.span("step.exchange"):
                    pulled = exchange(table, offsets, bt, i)
                with trace.span("step.assemble"):
                    feats = [assemble_features(
                        table[w], bases[w], None, None, query[i, w],
                        pulled[w], backend=assemble_backend)
                        for w in range(P_)]
                params, opt_state, loss, acc = _pmean_train_step(
                    cfg, opt, params, opt_state, feats, _step_inputs(bt, i))
                losses.append(loss)
                accs.append(acc)
        return params, opt_state, torch.stack(losses), torch.stack(accs)

    return epoch_fn


def make_rank_step(cfg: GNNConfig, opt, m_max: int, group=None,
                   assemble_backend: str = "auto", pipelined: bool = True):
    """-> step(params, opt_state, shard, x, pulled=None) -> (params,
    opt_state, loss, acc, pulled_next): one rank's step of an epoch
    program over a ``torch.distributed`` process group (``None``: the
    world), the per-device scan body of the reference's epochs.

    ``shard`` holds this rank's ``table`` (n_per, d), ``base`` (its first
    device slot, an int), ``cache_ids`` (n_hot,) sorted int32 and
    ``cache_feats`` (n_hot, d); ``x`` one step's ``input_nodes`` (m_max,),
    ``labels``, ``seed_mask``, per-layer ``edge_src``/``edge_dst``/
    ``edge_mask`` and pull lanes ``send_ids``/``send_pos``/``send_mask``
    (G, k), row g to rank g.

    Pipelined (Alg. 1): the lanes are step i+1's, pulled (``pull_shard``,
    two all-to-alls) with no dependence on this step's training, which
    assembles ``pulled`` -- step i's rows, pulled by the step before --
    local shard > C_s > pulled; the pull is returned for the next step.
    On-demand (``pipelined=False``): the lanes are this step's own, the
    pull feeds this step's cache-less assembly (local > pulled), and
    ``pulled`` is not taken. Then the GraphSAGE loss and gradients, one
    ``all_reduce(SUM)`` of the gradients, loss and accuracy packed into
    one float32 buffer, divided by the group's size (the reference's
    ``pmean``), and the optimizer update."""
    import torch.distributed as dist

    def step(params, opt_state, shard, x, pulled=None):
        table, base = shard["table"], int(shard["base"])
        lanes = (x["send_ids"], x["send_pos"], x["send_mask"])
        nxt = pull_shard(table, *lanes, base, m_max, group=group)
        if pipelined:
            cids, cfeats, rows = shard["cache_ids"], shard["cache_feats"], \
                pulled
        else:
            cids, cfeats, rows, nxt = None, None, nxt, None
        feats = assemble_features(table, base, cids, cfeats,
                                  to_device_ids(x["input_nodes"]), rows,
                                  backend=assemble_backend)
        loss, acc, grads = loss_and_grads(cfg, params, {
            "features": feats, "edge_src": x["edge_src"],
            "edge_dst": x["edge_dst"], "edge_mask": x["edge_mask"],
            "labels": x["labels"], "seed_mask": x["seed_mask"]})
        leaves = tree_leaves(grads)
        buf = torch.cat([g.reshape(-1).float() for g in leaves]
                        + [loss.reshape(1), acc.reshape(1)])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf = buf / dist.get_world_size(group)
        parts = iter(torch.split(buf[:-2], [g.numel() for g in leaves]))
        grads = tree_map(lambda g: next(parts).reshape(g.shape), grads)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, buf[-2], buf[-1], nxt

    return step


def empty_caches(num_parts: int, feat_dim: int) -> List[DeviceCache]:
    """Per-worker EMPTY hot sets: the no-cache (baseline) collation key.
    ``_batch_miss`` then routes every remote id through the pull lanes."""
    return [DeviceCache(ids=np.zeros(0, np.int64),
                        feats=np.zeros((0, feat_dim), np.float32))
            for _ in range(num_parts)]
