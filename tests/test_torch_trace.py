"""The port's tracer (``repro_torch.core.trace``) and the spans and
counter of the multi-epoch runner, on the CPU.

The tracer alone: nothing recorded while off, a span's parent on its
own thread or by ``cause`` across threads, attrs inherited, counters,
``clear``; no span or count lost across many threads; its stamps on the
profiler's clock. The runner on the tiny
graph (4 greedy parts, B = 16, 3 epochs, lazy schedules from the device
compiler's plain versions): one bootstrap ``runner.stage`` a ``run`` and
one staged on the staging thread for every later epoch, S ``epoch.step``
spans an epoch each with its four children, every ``DeviceEpochReport``
timing equal to its span's length, ``runner.h2d_bytes`` equal to the
bytes of the arrays copied, ``runner.card_collations`` one a staged
epoch, and losses and parameters bit-equal with tracing on and off.
"""
import dataclasses
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.core import build_schedule, trace
from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                              DeviceView, make_mesh)
from repro_torch.fault import FaultPlan, active_plan, plan_from_profile
from repro_torch.graph import KHopSampler, load_dataset, partition_graph
from repro_torch.models.gnn import GNNConfig, init_params
from repro_torch.train import AdamW
from repro_torch.train.checkpoint import _flatten
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

CPU = torch.device("cpu")
P_, B, EPOCHS, N_HOT, FANOUTS = 4, 16, 3, 64, (5, 5)
STEP_CHILDREN = ["step.assemble", "step.exchange", "step.forward_backward",
                 "step.optimizer"]


@pytest.fixture
def tracing():
    """The tracer on and cleared for one test, off and cleared after."""
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


@pytest.fixture(scope="module")
def world():
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    smp = KHopSampler(g, fanouts=list(FANOUTS), batch_size=B)
    ws = [build_schedule(smp, pg, worker=w, s0=7, num_epochs=EPOCHS,
                         n_hot=N_HOT, compiler="device", lazy=True,
                         device=CPU) for w in range(P_)]
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=32,
                    num_classes=g.num_classes, num_layers=2,
                    fanouts=FANOUTS, agg_backend="kernel")
    return g, ws, DeviceView.build(pg), cfg


def _runner(world, cls=DeviceRapidGNNRunner, **kw):
    g, ws, dv, cfg = world
    return cls(ws, dv, cfg, AdamW(lr=3e-3),
               make_mesh((P_,), ("data",), device=CPU), B, g.labels, **kw)


def _p0(world):
    return init_params(world[3], torch.Generator().manual_seed(5), CPU)


def _secs(s) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e9


def _by(spans, name, **attrs):
    return [s for s in spans if s["name"] == name
            and all(s["attrs"].get(k) == v for k, v in attrs.items())]


def _staged_bytes(runner, e: int) -> int:
    """Bytes staging epoch ``e`` copies to the device: the workers' flat
    schedules (input nodes, seeds, every layer's edges), two int64
    numbers a batch for each padded field's slots (input nodes, seeds, a
    layer's edges), and with a cache the hot sets' ids and the stacked
    C_sec (the baseline stages neither)."""
    flats = [ws.epoch(e).flat for ws in runner.schedules]
    n = sum(f.input_nodes.nbytes + f.seeds.nbytes
            + sum(f.edge_src[l].nbytes + f.edge_dst[l].nbytes
                  + f.edge_mask[l].nbytes for l in range(f.num_layers))
            for f in flats)
    n += 16 * (2 + len(runner.edge_max)) * sum(f.num_batches
                                               for f in flats)
    if runner.uses_cache:
        ids = sum(int(np.asarray(ws.epoch(e).cache_ids).size)
                  for ws in runner.schedules)
        d = runner.dv.table.shape[-1]
        n += 8 * ids + runner.P * runner.n_hot * (8 + 4 * d)
    return n


def _bits(tree) -> dict:
    return {k: v.detach().numpy().tobytes()
            for k, v in _flatten(tree).items()}


# ---------------------------------------------------------------------------
# the tracer alone
# ---------------------------------------------------------------------------

def test_off_records_nothing():
    trace.clear()
    assert not trace.TRACER.on
    with trace.span("a", epoch=0) as s:
        trace.count("c", 5)
    assert not isinstance(s, trace.Span)
    with trace.timed("b") as t:
        time.sleep(0.001)
    assert t.seconds >= 0.001 and t.id is None
    assert trace.export() == {"spans": [], "counters": {}}


def test_parents_attrs_threads_and_counters(tracing):
    with trace.timed("outer", epoch=3) as outer:
        with trace.span("inner", step=1):
            with trace.span("leaf"):
                trace.count("bytes", 7)
        def elsewhere():
            with trace.timed("elsewhere", cause=outer, epoch=4):
                pass
        th = threading.Thread(target=elsewhere, name="staging")
        th.start()
        th.join(timeout=10)
        assert not th.is_alive()
    trace.count("bytes", 5)
    out = trace.export()
    assert out["counters"] == {"bytes": 12}
    s = {x["name"]: x for x in out["spans"]}
    assert s["outer"]["parent"] is None
    assert s["inner"]["parent"] == s["outer"]["id"]
    assert s["leaf"]["parent"] == s["inner"]["id"]
    assert s["leaf"]["attrs"] == {"epoch": 3, "step": 1}
    assert s["elsewhere"]["parent"] == s["outer"]["id"]
    assert s["elsewhere"]["attrs"] == {"epoch": 4}
    assert s["elsewhere"]["thread"] == "staging"
    assert s["elsewhere"]["thread_id"] != s["outer"]["thread_id"]
    assert s["outer"]["thread"] == threading.current_thread().name
    assert _secs(s["outer"]) == outer.seconds
    for x in out["spans"]:
        assert x["start_ns"] <= x["end_ns"]
    assert [x["name"] for x in out["spans"]][:3] == ["outer", "inner",
                                                      "leaf"]
    trace.clear()
    assert trace.export() == {"spans": [], "counters": {}}


def test_threads_lose_no_span_and_no_count(tracing):
    """More threads than cores, a short switch interval: every span and
    every count of every thread is kept, each span's parent is on its
    own thread, and no two spans share an id."""
    import os
    import sys

    T, N = 2 * (os.cpu_count() or 4) + 2, 1000
    start = threading.Barrier(T)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            start.wait(timeout=60)
            for _ in range(N):
                with trace.span("outer"):
                    with trace.span("inner"):
                        trace.count("n", 1)
        threads = [threading.Thread(target=work) for _ in range(T)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    out = trace.export()
    assert out["counters"] == {"n": T * N}
    sp = out["spans"]
    assert len(sp) == 2 * T * N
    by_id = {s["id"]: s for s in sp}
    assert len(by_id) == len(sp)
    for s in sp:
        if s["name"] == "inner":
            up = by_id[s["parent"]]
            assert up["name"] == "outer"
            assert up["thread_id"] == s["thread_id"]
        else:
            assert s["parent"] is None


def test_stamps_on_the_profilers_clock(tracing):
    """A span around a profiled operator contains the profiler's host
    record of it: one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("mm"):
            x @ x
    sp = _by(trace.export()["spans"], "mm")[0]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm" and e.device_type() == DeviceType.CPU]
    assert len(ops) == 1
    assert sp["start_ns"] <= ops[0].start_ns()
    assert ops[0].start_ns() + ops[0].duration_ns() <= sp["end_ns"]


# ---------------------------------------------------------------------------
# the runner's spans
# ---------------------------------------------------------------------------

def test_runner_off_records_nothing(world):
    trace.clear()
    _runner(world).run(params=_p0(world))
    assert trace.export() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("cls", [DeviceRapidGNNRunner, DeviceBaselineRunner],
                         ids=["rapid", "baseline"])
def test_runner_spans_and_reports(world, tracing, cls):
    runner = _runner(world, cls)
    reports = runner.run(params=_p0(world)) + runner.run(
        runner.params, runner.opt_state, 1, EPOCHS)
    out = trace.export()
    sp = out["spans"]
    S = runner.num_steps
    assert len(_by(sp, "runner.run")) == 2
    assert len(_by(sp, "runner.table_copy")) == 2
    boot = _by(sp, "runner.stage", bootstrap=1)
    staged = [s for s in _by(sp, "runner.stage") if s not in boot]
    assert sorted(s["attrs"]["epoch"] for s in boot) == [0, 1]
    assert sorted(s["attrs"]["epoch"] for s in staged) == [1, 2, 2]
    epochs = {s["id"]: s for s in _by(sp, "runner.epoch")}
    main = {s["thread_id"] for s in epochs.values()}
    assert len(main) == 1
    for s in staged:
        # on the staging thread, caused by the epoch that submitted it
        assert s["thread"].startswith("runner-stage")
        assert s["thread_id"] not in main
        cause = epochs[s["parent"]]
        assert cause["attrs"]["epoch"] == s["attrs"]["epoch"] - 1
        kids = Counter(c["name"] for c in sp if c["parent"] == s["id"])
        hot = 2 if cls is DeviceRapidGNNRunner else 1
        assert kids == {"stage.compile": 1, "stage.collate": 1,
                        "stage.hot_set": hot}
    for s in boot:
        assert s["thread_id"] in main
    for ep in epochs.values():
        steps = [s for s in sp if s["name"] == "epoch.step"
                 and s["parent"] == ep["id"]]
        assert sorted(s["attrs"]["step"] for s in steps) == list(range(S))
        assert {s["attrs"]["epoch"] for s in steps} == {ep["attrs"]["epoch"]}
        for st in steps:
            kids = sorted(c["name"] for c in sp if c["parent"] == st["id"])
            assert kids == STEP_CHILDREN
            assert st["thread_id"] in main
    assert len(_by(sp, "epoch.prologue")) == len(reports)
    # every report timing is its span's length
    run_epochs = _by(sp, "runner.epoch")
    assert len(run_epochs) == len(reports) == 5
    for r, ep in zip(reports, run_epochs):
        e = r.epoch
        assert ep["attrs"]["epoch"] == e
        assert r.wall_time_s == _secs(ep)
        copy = [s for s in sp if s["name"] == "runner.boundary_copy"
                and s["parent"] == ep["id"]]
        assert len(copy) == 1 and r.copy_s == _secs(copy[0])
        aw = [s for s in sp if s["name"] == "runner.await_stage"
              and s["parent"] == ep["id"]]
        nxt = [s for s in staged if s["parent"] == ep["id"]]
        if e + 1 < EPOCHS:
            assert r.exposed_stage_s == _secs(aw[0])
            assert r.stage_s == _secs(nxt[0])
        else:
            assert aw == nxt == [] and r.exposed_stage_s == r.stage_s == 0.0
    assert runner.stage_time_s == pytest.approx(
        sum(_secs(s) for s in _by(sp, "runner.stage")), rel=1e-12)
    assert runner.exposed_stage_s == pytest.approx(
        sum(_secs(s) for s in _by(sp, "runner.await_stage")), rel=1e-12)
    # the bytes copied to the device: the table and offsets at each run
    # call, the collation's id and label lookups once, what staging
    # uploads for each epoch
    dv = runner.dv
    want = 2 * (dv.table.nbytes + dv.offsets.nbytes) + dv.g2d.nbytes + \
        runner.labels.nbytes
    want += sum(_staged_bytes(runner, r.epoch) for r in reports)
    assert out["counters"] == {"runner.h2d_bytes": want,
                               "runner.card_collations": len(reports)}


def test_runner_bit_equal_with_tracing_on_and_off(world):
    off = _runner(world)
    r_off = off.run(params=_p0(world))
    trace.clear()
    trace.enable()
    try:
        on = _runner(world)
        r_on = on.run(params=_p0(world))
    finally:
        trace.disable()
        trace.clear()
    for a, b in zip(r_off, r_on):
        np.testing.assert_array_equal(a.losses, b.losses)
        np.testing.assert_array_equal(a.accs, b.accs)
    assert _bits(on.params) == _bits(off.params)
    assert _bits(on.opt_state) == _bits(off.opt_state)


@pytest.mark.parametrize("profile", ["cache-loss", "stage-deadline"])
def test_recovery_wall_is_its_spans(world, tracing, profile):
    kw = {"stage_deadline_s": 0.05} if profile == "stage-deadline" else {}
    runner = _runner(world, **kw)
    plan = plan_from_profile(profile, seed=3)
    if profile == "stage-deadline":
        # the stage must still hang at the deadline under load
        plan = FaultPlan(plan.seed, [dataclasses.replace(r, delay_s=3.0)
                                     for r in plan.rules], name=profile)
    with active_plan(plan):
        runner.run(params=_p0(world))
    rec = _by(trace.export()["spans"], "runner.recover")
    assert rec and runner.recovery_wall_s > 0.0
    assert runner.recovery_wall_s == pytest.approx(
        sum(_secs(s) for s in rec), rel=1e-12)
