"""Host-side replay of the device pull plans for byte accounting.

Rebuilds the exact deterministic schedule a host-sim cell consumed and
pushes every batch through ``build_pull_plan``, yielding the device
path's payload (true residual-miss rows -- must equal the host sim's
``remote_bytes`` exactly) and wire bytes (the padded all_to_all lanes
the static-shape collective actually moves). Pure numpy: no mesh, no
subprocess -- this is the single-device cross-check used by the
``fig4_comm_volume`` benchmark; full on-mesh accounting comes from the
campaign's device cells.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def replay_device_bytes(dataset: str, batch_size: int, workers: int,
                        epochs: int, n_hot: int, s0: int = 42,
                        worker: int = 0,
                        fanouts: Sequence[int] = (25, 10),
                        partition: str = "metis"
                        ) -> Tuple[int, int, int, int, int]:
    """-> (payload_bytes, wire_bytes, request_bytes, cache_bytes, steps)
    for one worker.

    The lane bound ``k_max`` is the ALL-workers epoch maximum
    (``epoch_k_max``), as the compiled collective uses -- wire bytes
    reflect what actually moves, not worker-local padding.
    ``request_bytes`` is the id-lane leg shipped BEFORE each payload
    comes back (the previously unaccounted half of the wire)."""
    from repro_torch.graph import load_dataset, partition_graph, KHopSampler
    from repro_torch.core import build_schedule
    from repro_torch.dist import DeviceView, build_pull_plan, epoch_k_max
    from repro_torch.dist.gnn_step import _batch_miss

    g = load_dataset(dataset)
    pg = partition_graph(g, workers, partition)
    sampler = KHopSampler(g, fanouts=list(fanouts),
                          batch_size=batch_size)
    ws_all = [build_schedule(sampler, pg, worker=w, s0=s0,
                             num_epochs=epochs, n_hot=n_hot)
              for w in range(workers)]
    dv = DeviceView.build(pg)
    row = g.feat_dim * g.features.itemsize
    payload = wire = request = cache = steps = 0
    for e in range(epochs):
        es_list = [ws.epoch(e) for ws in ws_all]
        caches = [dv.remap_cache(es.cache_ids) for es in es_list]
        cache += es_list[worker].cache_ids.shape[0] * row   # VectorPull
        k_max = epoch_k_max(es_list, caches, dv)
        for b in es_list[worker].batches:
            dev, miss = _batch_miss(b, caches[worker], dv, worker)
            plan = build_pull_plan(dev[miss].astype(np.int32),
                                   np.flatnonzero(miss).astype(np.int32),
                                   dv.owner_d, pg.num_parts, k_max)
            payload += plan.payload_bytes(row)
            wire += plan.wire_bytes(row)
            request += plan.request_bytes()
            steps += 1
    return payload, wire, request, cache, steps


def replay_topology_bytes(dataset: str, batch_size: int, workers: int,
                          epochs: int, n_hot: int, hosts: int,
                          s0: int = 42,
                          fanouts: Sequence[int] = (25, 10),
                          partition: str = "metis",
                          dcn_bias: float = 0.0) -> dict:
    """Two-tier traffic cut for the topology benchmark (Fig-4 style).

    Replays EVERY worker's schedule and splits each residual miss by the
    owner's host under a ``hosts x (workers // hosts)`` topology:
    same-host misses ride the cheap ici wire, cross-host misses the DCN.
    Returns totals for both tiers plus the flat total they must sum to
    (the byte-sum identity) -- and, when ``dcn_bias > 0``, the same
    accounting under a DCN-biased hot set (``select_hot_set`` weighted
    toward cross-host owners), quantifying how much inter-host traffic
    the bias removes."""
    from repro_torch.graph import load_dataset, partition_graph, KHopSampler
    from repro_torch.core import build_schedule
    from repro_torch.dist import (DeviceView, Topology, build_pull_plan,
                            epoch_k_max)
    from repro_torch.dist.gnn_step import _batch_miss

    topo = Topology.hierarchical(hosts, workers // hosts)
    g = load_dataset(dataset)
    pg = partition_graph(g, workers, partition)
    sampler = KHopSampler(g, fanouts=list(fanouts),
                          batch_size=batch_size)
    row = g.feat_dim * g.features.itemsize
    dv = DeviceView.build(pg)

    def _account(owner_bias):
        """-> (intra, inter, flat) bytes over all workers and epochs.

        ``intra``/``inter`` split each miss by the owner's host;
        ``flat`` re-counts the SAME misses through ``build_pull_plan``
        (the flat-mesh wire format), so intra + inter == flat is a
        cross-accounting identity, not a tautology."""
        ws_all = [build_schedule(sampler, pg, worker=w, s0=s0,
                                 num_epochs=epochs, n_hot=n_hot,
                                 owner_bias=owner_bias[w]
                                 if owner_bias is not None else None)
                  for w in range(workers)]
        intra = inter = flat = 0
        for e in range(epochs):
            es_list = [ws.epoch(e) for ws in ws_all]
            caches = [dv.remap_cache(es.cache_ids) for es in es_list]
            k_max = epoch_k_max(es_list, caches, dv)
            for w in range(workers):
                for b in es_list[w].batches:
                    dev, miss = _batch_miss(b, caches[w], dv, w)
                    owners = np.asarray(dv.owner_d)[dev[miss]]
                    same = int(np.count_nonzero(
                        topo.same_host(owners, w)))
                    intra += same * row
                    inter += (int(miss.sum()) - same) * row
                    plan = build_pull_plan(
                        dev[miss].astype(np.int32),
                        np.flatnonzero(miss).astype(np.int32),
                        dv.owner_d, pg.num_parts, k_max)
                    flat += plan.payload_bytes(row)
        return intra, inter, flat

    intra, inter, flat = _account(None)
    out = {"hosts": hosts, "devices_per_host": workers // hosts,
           "intra_bytes": intra, "inter_bytes": inter,
           "flat_bytes": flat}
    if dcn_bias > 0:
        bias = [topo.owner_bias(w, dcn_bias) for w in range(workers)]
        bi, bx, bf = _account(bias)
        out["biased_intra_bytes"] = bi
        out["biased_inter_bytes"] = bx
        out["biased_flat_bytes"] = bf
        out["dcn_bias"] = dcn_bias
    return out
