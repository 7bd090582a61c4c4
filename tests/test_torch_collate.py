"""The device collation (``repro_torch.dist.device_collate``) against
the numpy ``collate_device_epoch``, on the CPU.

Every array of the collated epoch bit-equal, dtype for dtype and shape
for shape, on the tiny graph (4 greedy parts, B = 16): flat and ``2x2``,
with hot sets and without (the baseline's), uneven workers (fully
masked tail steps), an empty worker, an epoch of no batches, the
membership table at its size bound and the binary search one past it;
lane overflow one below the exact bound raising ``pack_pull_lanes``'
message. Then the runners staging through it over 3 lazy epochs: the
curves, lanes and wire rows bit-equal to the same runners collating with
the numpy function, host parity, and ``runner.card_collations`` one a
staged epoch.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import EpochSchedule, build_schedule, trace
from repro_torch.core.schedule import merge_pad_bounds
from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                              DeviceView, Topology, assert_host_parity,
                              collate_device_epoch, device_collate,
                              empty_caches, epoch_k_max, epoch_k_max_split,
                              make_mesh, runner as runner_mod)
from repro_torch.dist.device_collate import (collate_epoch_on_device,
                                             lane_totals, to_host_epoch,
                                             upload)
from repro_torch.dist.gnn_step import tree_to_device
from repro_torch.graph import (FlatEpoch, KHopSampler, load_dataset,
                               partition_graph)
from repro_torch.models.gnn import GNNConfig, init_params
from repro_torch.train import AdamW
from repro_torch.train.checkpoint import _flatten
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

CPU = torch.device("cpu")
P_, B, EPOCHS, N_HOT, FANOUTS = 4, 16, 3, 64, (5, 5)


def _graph(kind: str):
    """The tiny graph, its train mask cut for ``kind``: ``uneven``
    leaves worker 3 half a batch, ``empty`` worker 2 nothing."""
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    tm = g.train_mask.copy()
    if kind == "uneven":
        l3 = pg.local_nodes[3]
        keep = l3[tm[l3]][:B // 2]
        tm[l3] = False
        tm[keep] = True
    elif kind == "empty":
        tm[pg.local_nodes[2]] = False
    g = dataclasses.replace(g, train_mask=tm)
    return g, partition_graph(g, P_, "greedy")


def _world(kind="full", epochs=2, **kw):
    g, pg = _graph(kind)
    smp = KHopSampler(g, fanouts=list(FANOUTS), batch_size=B)
    ws = [build_schedule(smp, pg, worker=w, s0=7, num_epochs=epochs,
                         n_hot=N_HOT, **kw) for w in range(P_)]
    return g, pg, ws, DeviceView.build(pg)


@pytest.fixture(scope="module")
def worlds():
    return {k: _world(k) for k in ("full", "uneven", "empty")}


def _equal(got, want, path="epoch"):
    """Bit-equal trees: the same keys, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, (path, got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), path


def _args(world, e, cached, layout):
    """The collation's arguments for epoch ``e``, at the exact lane
    bounds: (es_list, caches, kwargs)."""
    g, _, ws, dv = world
    es = [w.epoch(e) for w in ws]
    caches = ([dv.remap_cache(x.cache_ids) for x in es] if cached
              else empty_caches(P_, g.feat_dim))
    m_max, edge_max = merge_pad_bounds(ws)
    kw = dict(batch_size=B, m_max=m_max, edge_max=edge_max,
              num_steps=max(1, max(x.num_batches for x in es)))
    if layout == "flat":
        kw["k_max"] = epoch_k_max(es, caches, dv)
    else:
        topo = Topology.parse(layout, P_)
        kw["k_max"], kw["k_max_inter"] = epoch_k_max_split(es, caches, dv,
                                                            topo)
        kw["topology"] = topo
    return es, caches, kw


def _on_device(world, es, caches, **kw):
    """The device collation with the labels and id map uploaded."""
    g, _, _, dv = world
    return collate_epoch_on_device(es, caches, dv, upload(g.labels, CPU),
                                   device=CPU, g2d=upload(dv.g2d, CPU), **kw)


def _both(world, es, caches, kw):
    g, _, _, dv = world
    want = collate_device_epoch(es, caches, dv, g.labels, **kw)
    got, counts = _on_device(world, es, caches, **kw)
    return to_host_epoch(got), counts, want


CASES = [("full", True, "flat"), ("full", True, "2x2"),
         ("full", False, "flat"), ("full", False, "2x2"),
         ("uneven", True, "flat"), ("uneven", True, "2x2"),
         ("empty", True, "flat"), ("empty", False, "2x2")]


@pytest.mark.parametrize("kind,cached,layout", CASES,
                         ids=[f"{k}-{'cached' if c else 'nocache'}-{l}"
                              for k, c, l in CASES])
@pytest.mark.parametrize("e", [0, 1])
def test_bit_equal_to_numpy(worlds, kind, cached, layout, e):
    world = worlds[kind]
    es, caches, kw = _args(world, e, cached, layout)
    got, counts, want = _both(world, es, caches, kw)
    _equal(got, want)
    # the counts are the lanes the masks hold
    keys = ("send",) if layout == "flat" else ("intra", "inter")
    for k in keys:
        np.testing.assert_array_equal(counts[k],
                                      want[f"{k}_mask"].sum(axis=-1))
    intra, inter = lane_totals(counts)
    masks = [want[f"{k}_mask"].sum(axis=(0, 2, 3)) for k in keys]
    np.testing.assert_array_equal(intra + inter, sum(masks))
    if kind == "uneven":
        assert es[3].num_batches < kw["num_steps"]
        assert not want["seed_mask"][-1, 3].any()
    if kind == "empty":
        assert es[2].num_batches == 0
        assert not got["seed_mask"][:, 2].any()


@pytest.mark.parametrize("past", [0, 1], ids=["table_at_bound",
                                              "search_past_bound"])
def test_membership_bound_bit_equal(worlds, monkeypatch, past):
    """The membership table up to ``STAMP_TABLE_MAX_SLOTS`` (P x slots)
    and a binary search over the cache keys one past it: the same
    epoch."""
    dv = worlds["full"][3]
    monkeypatch.setattr(device_collate, "STAMP_TABLE_MAX_SLOTS",
                        P_ * dv.num_parts * dv.n_per - past)
    for layout in ("flat", "2x2"):
        es, caches, kw = _args(worlds["full"], 1, True, layout)
        got, _, want = _both(worlds["full"], es, caches, kw)
        _equal(got, want)


def test_no_batches_at_all(worlds):
    """An epoch in which no worker has a batch: every step masked."""
    g, _, ws, dv = worlds["full"]
    es = [EpochSchedule(epoch=0, flat=FlatEpoch.empty(0, w, 2))
          for w in range(P_)]
    m_max, edge_max = merge_pad_bounds(ws)
    for layout in ("flat", "2x2"):
        topo = Topology.parse(layout, P_)
        kw = dict(batch_size=B, m_max=m_max, edge_max=edge_max, k_max=3,
                  num_steps=2, topology=topo, k_max_inter=2)
        got, counts, want = _both(worlds["full"], es,
                                  empty_caches(P_, g.feat_dim), kw)
        _equal(got, want)
        assert all(not c.any() for c in counts.values())


@pytest.mark.parametrize("layout", ["flat", "2x2"])
@pytest.mark.parametrize("cached", [True, False])
def test_overflow_raises_the_same_error(worlds, layout, cached):
    """``k_max`` (and on 2x2 each tier's bound in turn) one below the
    exact bound: both collations raise ``pack_pull_lanes``' message."""
    world = worlds["full"]
    es, caches, kw = _args(world, 1, cached, layout)
    bounds = ["k_max"] if layout == "flat" else ["k_max", "k_max_inter"]
    for b in bounds:
        low = dict(kw, **{b: kw[b] - 1})
        with pytest.raises(ValueError, match="pull plan overflow") as want:
            collate_device_epoch(es, caches, world[3], world[0].labels,
                                 **low)
        with pytest.raises(ValueError, match="pull plan overflow") as got:
            _on_device(world, es, caches, **low)
        assert str(got.value) == str(want.value)


def test_too_few_steps_raises(worlds):
    es, caches, kw = _args(worlds["full"], 0, True, "flat")
    kw["num_steps"] -= 1
    with pytest.raises(ValueError, match="more batches than num_steps"):
        _on_device(worlds["full"], es, caches, **kw)


# ---------------------------------------------------------------------------
# the runners staging through it
# ---------------------------------------------------------------------------

def _numpy_collation(es_list, caches, dv, labels, *args, device, g2d, **kw):
    """The numpy oracle in the device collation's place: its epoch as
    tensors, its lane counts from the masks."""
    out = collate_device_epoch(es_list, caches, dv, labels.numpy(), *args,
                               **kw)
    keys = ("intra", "inter") if "intra_mask" in out else ("send",)
    counts = {k: out[f"{k}_mask"].sum(axis=-1).astype(np.int64)
              for k in keys}
    return tree_to_device(out, device), counts


def _bits(tree) -> dict:
    return {k: v.detach().numpy().tobytes()
            for k, v in _flatten(tree).items()}


@pytest.fixture(scope="module")
def lazy_world():
    return _world("full", epochs=EPOCHS, compiler="device", lazy=True,
                  device=CPU)


RUNNERS = [("rapid", "flat"), ("rapid", "2x2"), ("baseline", "flat")]


@pytest.mark.parametrize("kind,layout", RUNNERS,
                         ids=[f"{k}-{l}" for k, l in RUNNERS])
def test_runner_bit_equal_to_numpy_collation(lazy_world, monkeypatch, kind,
                                             layout):
    g, pg, ws, dv = lazy_world
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=32,
                    num_classes=g.num_classes, num_layers=2,
                    fanouts=FANOUTS, agg_backend="kernel")
    topo = Topology.parse(layout, P_)
    cls = DeviceRapidGNNRunner if kind == "rapid" else DeviceBaselineRunner

    def run():
        r = cls(ws, dv, cfg, AdamW(lr=3e-3),
                topo.make_mesh(CPU) if topo.is_hierarchical
                else make_mesh((P_,), ("data",), device=CPU), B, g.labels,
                topology=topo)
        return r, r.run(params=init_params(
            cfg, torch.Generator().manual_seed(5), CPU))

    trace.clear()
    trace.enable()
    try:
        card, reports = run()
        counters = trace.export()["counters"]
    finally:
        trace.disable()
        trace.clear()
    assert counters["runner.card_collations"] == len(reports) == EPOCHS
    assert card.trace_count == 1
    if kind == "rapid":
        assert_host_parity(ws, pg, B, reports)
    with monkeypatch.context() as m:
        m.setattr(runner_mod, "collate_epoch_on_device", _numpy_collation)
        oracle, want = run()
    assert oracle.trace_count == 1
    for a, b in zip(reports, want):
        np.testing.assert_array_equal(a.losses, b.losses)
        np.testing.assert_array_equal(a.accs, b.accs)
        for f in ("miss_lanes", "intra_lanes", "inter_lanes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert getattr(a, f).dtype == np.int64
        for f in ("wire_rows", "intra_wire_rows", "inter_wire_rows",
                  "steps"):
            assert getattr(a, f) == getattr(b, f)
    assert _bits(card.params) == _bits(oracle.params)
    assert _bits(card.opt_state) == _bits(oracle.opt_state)
