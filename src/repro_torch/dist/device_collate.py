"""The staged epoch collated on a torch device: the counterpart of
``gnn_step.collate_device_epoch`` that the multi-epoch runners stage
through.

The numpy function pads every worker's flat schedule into (S, P, ...)
slabs, classifies the residual misses and packs the pull lanes on the
host; the runner then copied those padded slabs to the card.
``collate_epoch_on_device`` uploads the P workers' ``FlatEpoch``
payloads once, unpadded, and builds the same dict on the device: every
array BIT-IDENTICAL to the numpy function's (dtypes, shapes, pad values
``-1`` ids, zeros and ``False`` masks, lane order), which the tests pin.

  * Slab fills: each element's destination ``(step, worker, slot)`` is
    its stream position plus a per-batch offset taken from the CSR
    starts (one ``repeat_interleave``), then one scatter per array.
  * Miss classification: a membership table keyed ``(worker, slot)``
    on the device (a binary search over the sorted ``(worker, id)``
    cache keys where the table would pass ``STAMP_TABLE_MAX_SLOTS``),
    remoteness by the owner ``id // n_per``, as ``_classify_misses``.
  * Lane packing: one sort of the ``(group, id)`` key, misses first
    (every other element takes a key past the real ones), the
    groups' starts by ``searchsorted`` over the sorted keys, lane ranks
    as the distance from the group's start, one scatter per output. The
    sampler dedupes each batch's input nodes, so ``(group, id)`` is
    unique and orders exactly as numpy's ``(group, id, pos)`` key (a
    duplicate would keep input order, ascending ``pos``, since both
    sorts are stable).
  * Lane overflow raises with ``pack_pull_lanes``' message: the lane
    counts come back to the host once (the one synchronisation), before
    any lane is written.

On a CPU device the same code runs, so the CPU tests run what the card
runs. Uploads count their bytes in the tracer's ``runner.h2d_bytes``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.schedule import EpochSchedule
from repro_torch.dist.feature_a2a import lane_overflow
from repro_torch.dist.gnn_step import (STAMP_TABLE_MAX_SLOTS, DeviceCache,
                                       DeviceView, _check_num_steps, _hier)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, its bytes counted."""
    trace.count("runner.h2d_bytes", a.nbytes)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _stream(parts: Sequence[np.ndarray], dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """The workers' flat arrays, worker-major, in one device tensor: each
    copied once into its slice (cast to ``dtype`` as the numpy slabs
    cast on assignment)."""
    out = torch.empty(sum(p.shape[0] for p in parts), dtype=dtype,
                      device=device)
    lo = 0
    for p in parts:
        if p.shape[0]:
            trace.count("runner.h2d_bytes", p.nbytes)
            out[lo:lo + p.shape[0]].copy_(
                torch.from_numpy(np.ascontiguousarray(p)))
        lo += p.shape[0]
    return out


def _slots(counts: Sequence[np.ndarray], workers: Sequence[int], P_: int,
           K: int, what: str, device: torch.device) -> torch.Tensor:
    """Flat ``((step * P + worker) * K + slot)`` destination of every
    element of the worker-major stream whose batches hold ``counts[i]``
    elements (worker ``workers[i]``, batch b at step b)."""
    adds, n = [], 0
    for c, w in zip(counts, workers):
        if c.size and int(c.max()) > K:
            raise ValueError(f"worker {w}: a batch of {int(c.max())} "
                             f"{what} > the pad bound {K}")
        st = n + np.concatenate([[0], np.cumsum(c)[:-1]])
        adds.append((np.arange(c.shape[0], dtype=np.int64) * P_ + w) * K
                    - st)
        n += int(c.sum())
    add = upload(np.concatenate(adds).astype(np.int64), device)
    rep = upload(np.concatenate(counts).astype(np.int64), device)
    return torch.arange(n, dtype=torch.int64, device=device) + \
        torch.repeat_interleave(add, rep, output_size=n)


def _slab(S: int, P_: int, K: int, fill, dtype: torch.dtype,
          dst: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    out = torch.full((S * P_ * K,), fill, dtype=dtype, device=dst.device)
    out[dst] = vals.to(dtype)
    return out.view(S, P_, K)


def _hits(dev: torch.Tensor, wk: torch.Tensor,
          caches: Sequence[DeviceCache], n_slots: int,
          device: torch.device) -> Optional[torch.Tensor]:
    """Whether each element's id is in its worker's hot set (None when
    every hot set is empty)."""
    keys = [w * n_slots + c.ids.astype(np.int64)
            for w, c in enumerate(caches) if c.ids.shape[0]]
    if not keys:
        return None
    ck = upload(np.concatenate(keys), device)   # sorted: w-major, ids sorted
    q = wk * n_slots + dev
    if len(caches) * n_slots <= STAMP_TABLE_MAX_SLOTS:
        table = torch.zeros(len(caches) * n_slots, dtype=torch.bool,
                            device=device)
        table[ck] = True
        return table[q]
    pos = torch.searchsorted(ck, q).clamp_(max=ck.shape[0] - 1)
    return ck[pos] == q


class _Tier:
    """One lane layout's sorted misses: (G, k) lanes of ``G`` groups."""

    def __init__(self, valid: torch.Tensor, gidx: torch.Tensor,
                 dev: torch.Tensor, col: torch.Tensor, G: int, k: int,
                 n_slots: int):
        self.G, self.k, self.n_slots, self.col = G, k, n_slots, col
        # real keys lie below ``span``; the other elements key ``span``,
        # which sorts after them
        span = G * n_slots
        key = torch.where(valid, gidx * n_slots + dev,
                          torch.full_like(dev, span))
        self.sk, self.perm = torch.sort(key, stable=True)
        bounds = torch.arange(G + 1, dtype=torch.int64,
                              device=key.device) * n_slots
        self.starts = torch.searchsorted(self.sk, bounds)   # (G + 1,)

    def lanes(self, n_miss: int, lead: Tuple[int, ...]
              ) -> Tuple[torch.Tensor, ...]:
        """-> (ids int32, pos int32, mask bool) of shape ``lead + (k,)``,
        the first ``n_miss`` sorted keys scattered to their lanes."""
        G, k, dev = self.G, self.k, self.sk.device
        sk = self.sk[:n_miss]
        g = sk // self.n_slots
        lane = torch.arange(n_miss, dtype=torch.int64, device=dev) - \
            self.starts[g]
        flat = g * k + lane
        ids = torch.zeros(G * k, dtype=torch.int32, device=dev)
        pos = torch.zeros(G * k, dtype=torch.int32, device=dev)
        mask = torch.zeros(G * k, dtype=torch.bool, device=dev)
        ids[flat] = (sk - g * self.n_slots).to(torch.int32)
        pos[flat] = self.col[self.perm[:n_miss]].to(torch.int32)
        mask[flat] = True
        shape = lead + (k,)
        return ids.view(shape), pos.view(shape), mask.view(shape)


def _empty_lanes(out: Dict[str, Any], tiers, device: torch.device) -> None:
    for name, shape in tiers:
        out[f"{name}_ids"] = torch.zeros(shape, dtype=torch.int32,
                                         device=device)
        out[f"{name}_pos"] = torch.zeros(shape, dtype=torch.int32,
                                         device=device)
        out[f"{name}_mask"] = torch.zeros(shape, dtype=torch.bool,
                                          device=device)


def collate_epoch_on_device(es_list: Sequence[EpochSchedule],
                            caches: Sequence[DeviceCache], dv: DeviceView,
                            labels: torch.Tensor, batch_size: int,
                            m_max: int, edge_max: Sequence[int], k_max: int,
                            num_steps: int, topology=None,
                            k_max_inter: Optional[int] = None, *,
                            device: torch.device, g2d: torch.Tensor
                            ) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """``collate_device_epoch`` on ``device``: the same arguments, the
    same dict with tensors on ``device`` for arrays, bit for bit.

    ``labels`` and ``g2d`` (``dv.g2d``) are tensors on ``device``, kept
    there by the caller across epochs (``upload`` them once).
    -> (the epoch dict, lane counts): per lane layout --
    ``"send"`` flat, ``"intra"`` and ``"inter"`` on a hierarchical
    ``topology`` -- the host (S, P, G) int64 count of each requesting
    (step, worker)'s lanes to each owner group G. Raises as the numpy
    function does: more batches than ``num_steps``, and lane overflow
    with ``pack_pull_lanes``' message."""
    P_, S = len(es_list), num_steps
    _check_num_steps(es_list, S)
    L = len(edge_max)
    hier = _hier(topology)
    if hier:
        D = topology.devices_per_host
        k_x = k_max_inter if k_max_inter is not None else k_max
        tiers = (("intra", (S, P_, D, k_max)), ("inter", (S, P_, P_, k_x)))
    else:
        tiers = (("send", (S, P_, P_, k_max)),)
    flats = [es.flat for es in es_list]
    live = [w for w, f in enumerate(flats) if f.num_batches]
    if not live:                    # no batches at all: every step masked
        out = {
            "input_nodes": torch.full((S, P_, m_max), -1, dtype=torch.int64,
                                      device=device),
            "labels": torch.zeros((S, P_, batch_size), dtype=torch.int32,
                                  device=device),
            "seed_mask": torch.zeros((S, P_, batch_size), dtype=torch.bool,
                                     device=device),
            "edge_src": [torch.zeros((S, P_, e), dtype=torch.int32,
                                     device=device) for e in edge_max],
            "edge_dst": [torch.zeros((S, P_, e), dtype=torch.int32,
                                     device=device) for e in edge_max],
            "edge_mask": [torch.zeros((S, P_, e), dtype=torch.bool,
                                      device=device) for e in edge_max],
        }
        _empty_lanes(out, tiers, device)
        return out, {n: np.zeros(s[:3], np.int64) for n, s in tiers}
    fl = [flats[w] for w in live]

    # the padded slabs: one scatter an array
    d_in = _slots([f.m_counts for f in fl], live, P_, m_max, "input nodes",
                  device)
    dev = g2d[_stream([f.input_nodes for f in fl], torch.int64, device)]
    out: Dict[str, Any] = {
        "input_nodes": _slab(S, P_, m_max, -1, torch.int64, d_in, dev)}
    d_seed = _slots([np.diff(f.seed_starts) for f in fl], live, P_,
                    batch_size, "seeds", device)
    seeds = _stream([f.seeds for f in fl], torch.int64, device)
    out["labels"] = _slab(S, P_, batch_size, 0, torch.int32, d_seed,
                          labels[seeds])
    out["seed_mask"] = _slab(S, P_, batch_size, False, torch.bool, d_seed,
                             torch.ones_like(seeds, dtype=torch.bool))
    for key in ("edge_src", "edge_dst", "edge_mask"):
        out[key] = []
    for l in range(L):
        d_e = _slots([np.diff(f.edge_starts[l]) for f in fl], live, P_,
                     edge_max[l], f"layer-{l} edges", device)
        for key, dtype in (("edge_src", torch.int32),
                           ("edge_dst", torch.int32),
                           ("edge_mask", torch.bool)):
            vals = _stream([getattr(f, key)[l] for f in fl], dtype, device)
            out[key].append(_slab(S, P_, edge_max[l], 0, dtype, d_e, vals))

    # residual misses: remote and not in the worker's hot set
    n_slots = dv.num_parts * dv.n_per
    row = d_in // m_max                     # step * P + worker
    col = d_in - row * m_max                # the batch buffer's row
    wk = row % P_
    owner = dev // dv.n_per
    miss = owner != wk
    hit = _hits(dev, wk, caches, n_slots, device)
    if hit is not None:
        miss &= ~hit
    if hier:
        same = owner // D == wk // D
        sorted_ = [_Tier(miss & same, row * D + owner % D, dev, col,
                         S * P_ * D, k_max, n_slots),
                   _Tier(miss & ~same, row * P_ + owner, dev, col,
                         S * P_ * P_, k_x, n_slots)]
        widths = (D, P_)
    else:
        sorted_ = [_Tier(miss, row * P_ + owner, dev, col, S * P_ * P_,
                         k_max, n_slots)]
        widths = (P_,)
    # the one synchronisation: every tier's lane counts, before any lane
    cnt = torch.cat([t.starts.diff() for t in sorted_]).cpu().numpy()
    counts, lo = {}, 0
    for (name, shape), t, G in zip(tiers, sorted_, widths):
        c = cnt[lo:lo + t.G]
        lo += t.G
        if c.size and int(c.max()) > t.k:
            raise lane_overflow(c, G, t.k)
        counts[name] = c.reshape(S, P_, G)
        for key, a in zip(("ids", "pos", "mask"),
                          t.lanes(int(c.sum()), shape[:3])):
            out[f"{name}_{key}"] = a
    return out, counts


def lane_totals(counts: Dict[str, np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(P,) lanes each worker requested over the epoch, split into the
    same-host and cross-host tiers (flat: every lane same-host)."""
    if "send" in counts:
        intra = counts["send"].sum(axis=(0, 2))
        return intra, np.zeros_like(intra)
    return counts["intra"].sum(axis=(0, 2)), counts["inter"].sum(axis=(0, 2))


def to_host_epoch(batches: Dict[str, Any]) -> Dict[str, Any]:
    """A collated epoch's tensors as numpy arrays (for comparisons)."""
    if isinstance(batches, dict):
        return {k: to_host_epoch(v) for k, v in batches.items()}
    if isinstance(batches, list):
        return [to_host_epoch(v) for v in batches]
    return batches.cpu().numpy()
