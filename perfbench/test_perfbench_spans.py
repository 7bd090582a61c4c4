"""The arithmetic that reads the program's spans, on hand-made spans and
device intervals: self time, the innermost span over each idle gap, the
idle time inside a span, the stage's parts and the per-kseed counter;
each span reader on a hand-made Context; and the span probe over a tiny
cell on the CPU."""
import json
import time
import types

import pytest
import torch

from perfbench import spanprobe, spans, testing
from perfbench.harness import load_reader
from perfbench.manifest import ROOT
from perfbench.trace import DeviceEvent, TraceData

RUNNER, STAGING = 1, 2


def sp(i, name, a, b, parent=None, thread=RUNNER, **attrs):
    return {"id": i, "name": name, "start_ns": a, "end_ns": b,
            "thread_id": thread, "thread": str(thread), "parent": parent,
            "attrs": attrs}


def hand_spans():
    """One epoch on the runner thread, one stage on the staging thread
    (caused by the epoch), and a bootstrap stage before the epoch."""
    return [sp(1, "runner.run", 0, 1000),
            sp(2, "runner.table_copy", 10, 30, 1),
            sp(3, "runner.stage", 30, 90, 1, epoch=0, bootstrap=1),
            sp(4, "stage.compile", 30, 80, 3, epoch=0, bootstrap=1),
            sp(5, "runner.epoch", 100, 900, 1, epoch=0),
            sp(6, "epoch.step", 200, 400, 5, epoch=0, step=0),
            sp(7, "step.exchange", 250, 300, 6, epoch=0, step=0),
            sp(8, "runner.await_stage", 600, 800, 5, epoch=0),
            sp(9, "runner.stage", 150, 750, 5, STAGING, epoch=1),
            sp(10, "stage.compile", 150, 450, 9, STAGING, epoch=1),
            sp(11, "stage.hot_set", 450, 470, 9, STAGING, epoch=1),
            sp(12, "stage.collate", 470, 740, 9, STAGING, epoch=1)]


#: the card busy over [50, 120), [220, 240), [700, 720)
BUSY = [(50, 120), (220, 240), (700, 720)]


def test_self_time_is_length_less_same_thread_children():
    own = spans.self_ns(hand_spans())
    # runner.epoch 800 less epoch.step 200 and await 200; the stage on
    # the staging thread takes nothing from it
    assert own[5] == 400
    assert own[6] == 150 and own[7] == 50
    assert own[1] == 1000 - 20 - 60 - 800
    assert own[9] == 600 - 300 - 20 - 270
    ms = spans.self_ms(hand_spans(), per=2)
    assert ms["runner.stage"] == (10 + 10) / 1e6 / 2


def test_innermost_pieces():
    runner = [s for s in hand_spans() if s["thread_id"] == RUNNER]
    got = spans.innermost(runner)
    assert got == [(0, 10, "runner.run"), (10, 30, "runner.table_copy"),
                   (30, 80, "stage.compile"), (80, 90, "runner.stage"),
                   (90, 100, "runner.run"), (100, 200, "runner.epoch"),
                   (200, 250, "epoch.step"), (250, 300, "step.exchange"),
                   (300, 400, "epoch.step"), (400, 600, "runner.epoch"),
                   (600, 800, "runner.await_stage"),
                   (800, 900, "runner.epoch"), (900, 1000, "runner.run")]


def test_idle_by_innermost_span():
    # idle: [0, 50) [120, 220) [240, 700) [720, 1000) and, past the
    # runner's last span, [1000, 1200): outside any span, though the
    # staging thread might be busy there
    s = hand_spans() + [sp(13, "runner.stage", 1000, 1200, None, STAGING)]
    got = spans.idle_by_span(s, BUSY, 0, 1200)
    assert got == {"runner.run": 10 + 100, "runner.table_copy": 20,
                   "stage.compile": 20, "runner.epoch": 80 + 200 + 100,
                   "epoch.step": 20 + 10 + 100, "step.exchange": 50,
                   "runner.await_stage": 100 + 80, spans.OUTSIDE: 200}
    assert sum(got.values()) == 50 + 100 + 460 + 280 + 200


def test_idle_within_a_span_counts_its_children():
    s = hand_spans()
    assert spans.idle_within(s, "runner.await_stage", BUSY, 0, 1000) == 180
    assert spans.idle_within(s, "epoch.step", BUSY, 0, 1000) == 180
    # a gap outside every such span counts nothing: none in [0, 100)
    assert spans.idle_within(s, "runner.epoch", BUSY, 0, 100) == 0
    # the staging thread's spans are not the runner's
    assert spans.idle_within(s, "stage.collate", BUSY, 0, 1000) == 0


def test_idle_intervals_clip_to_the_slice():
    assert spans.idle_intervals(BUSY, 60, 710) == [(120, 220), (240, 700)]
    assert spans.idle_intervals([], 5, 9) == [(5, 9)]


def test_stage_parts_and_steps_by_overlap():
    s = hand_spans()
    parts = spans.stage_parts_ms(s)
    assert parts == {"runner.stage": 600 / 1e6, "stage.collate": 270 / 1e6,
                     "stage.compile": 300 / 1e6, "stage.hot_set": 20 / 1e6}
    s.append(sp(14, "epoch.step", 700, 800, 5, step=1))
    s.append(sp(15, "epoch.step", 800, 850, 5, step=2))
    assert spans.step_ms_by_overlap(s) == {"overlapped": [200 / 1e6],
                                           "partly": [100 / 1e6],
                                           "alone": [50 / 1e6]}


def test_per_kseed():
    assert spans.per_kseed(12.0, 6000) == 2.0
    assert spans.per_kseed(1.0, 0) is None


def _ctx(**kw):
    rep = types.SimpleNamespace(epoch=0)
    base = dict(reports=[rep], seeds=3000)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _read(name, ctx):
    spec = json.loads((ROOT / "perfbench" / "metrics"
                       / f"{name}.json").read_text())
    return load_reader(ROOT, spec["reader"]).read(ctx, spec)


def test_span_readers_by_hand():
    whole = {"spans": hand_spans(),
             "counters": {"runner.h2d_bytes": 6_000_000}}
    gap = TraceData(window_s=1e-6, events=[
        DeviceEvent("k", a, b, "") for a, b in BUSY])
    ctx = _ctx(spans=whole, gap_spans=whole, gap_trace=gap,
               gap_slice=(0, 1000))
    assert _read("run_prologue_ms", ctx) == (20 + 60) / 1e6
    assert _read("stage_compile_ms", ctx) == 300 / 1e6
    assert _read("stage_hot_set_ms", ctx) == 20 / 1e6
    assert _read("stage_collate_ms", ctx) == 270 / 1e6
    assert _read("step_host_ms", ctx) == 200 / 1e6
    assert _read("idle_await_stage_ms", ctx) == 180 / 1e6
    assert _read("idle_in_step_ms", ctx) == 180 / 1e6
    # 6 MB over one epoch of 3000 seeds
    assert _read("h2d_mb_per_kseed", ctx) == 2.0


@pytest.mark.parametrize("name", spanprobe.METRICS)
def test_span_readers_read_nothing_without_spans(name):
    """A Context with no span export (a program without the tracer)
    gives no value, and raises nothing."""
    assert _read(name, _ctx()) is None
    assert _read(name, _ctx(spans={}, gap_spans={}, gap_trace=None)) is None


def test_probe_on_a_tiny_cell(tmp_path, monkeypatch, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        root, cell = testing.tiny_root(tmp_path, "lazy")
        monkeypatch.setattr(spanprobe, "ROOT", root)
        t = time.perf_counter()
        assert spanprobe.main(["--workload", cell, "--seed",
                               str(2 ** 31 + 977), "--pairs", "1"],
                              torch.device("cpu")) == 0
        assert time.perf_counter() - t < 120
    finally:
        torch.set_num_threads(n)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    m = out["metrics"]
    # the CPU has no device trace: the idle metrics read nothing
    assert m["idle_await_stage_ms"] is None and m["idle_in_step_ms"] is None
    for k in ("run_prologue_ms", "stage_compile_ms", "stage_hot_set_ms",
              "stage_collate_ms", "step_host_ms", "h2d_mb_per_kseed"):
        assert m[k] > 0, k
    parts = out["stage_parts_ms"]
    assert (parts["stage.compile"] + parts["stage.hot_set"]
            + parts["stage.collate"]) <= parts["runner.stage"]
    E = testing.TINY["epochs"]
    steps = sum(v["n"] for v in out["step_ms"].values())
    assert steps % E == 0 and steps > 0
    assert [on for on, _ in out["passes_on_off"]] == [False, True]
    assert out["counters"]["runner.h2d_bytes"] > 0
