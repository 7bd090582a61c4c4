"""The yardstick's arithmetic against hand counts on a small hand-made
schedule: the schedule counts, the residual-miss rows, the operations
of ``train_step_mfu``, the roofline bytes and the end-to-end rates."""
import types

import numpy as np
import pytest

from perfbench import hostinfo, summary
from perfbench.harness import Context, load_reader, read_metrics
from perfbench.manifest import ROOT, load_cell, load_manifest
from perfbench.trace import DeviceEvent, TraceData, base_name


def hand_flat():
    """Worker 0, two batches of a 2-layer schedule (fan-outs 2, 1):
    batch 0 has 2 seeds and input nodes [10, 11, 20, 30]; batch 1 one
    seed and input nodes [12, 21]. Layer 0 edges (dst-major, fan-out
    2), layer 1 (fan-out 1)."""
    return types.SimpleNamespace(
        input_nodes=np.array([10, 11, 20, 30, 12, 21], np.int64),
        input_starts=np.array([0, 4, 6]),
        seed_starts=np.array([0, 2, 3]),
        num_dst=np.array([[3, 1], [2, 1]]),
        # layer 0: batch 0 three dst x 2 edges, sources 2, 3, 2, 2, 1, 0
        # with the 4th edge masked; batch 1 one dst, sources 1, 1
        edge_src=[np.array([2, 3, 2, 2, 1, 0, 1, 1], np.int32),
                  np.array([2, 1, 1], np.int32)],
        edge_mask=[np.array([1, 1, 1, 0, 1, 1, 1, 1], bool),
                   np.array([1, 1, 0], bool)],
        edge_starts=[np.array([0, 6, 8]), np.array([0, 2, 3])])


def test_worker_counts_by_hand():
    wc = summary.worker_counts(hand_flat())
    assert wc["m"].tolist() == [4, 2]
    assert wc["seeds"].tolist() == [2, 1]
    assert wc["edges"].tolist() == [[5, 2], [2, 0]]
    # distinct unmasked sources: layer 0 {2, 3, 1, 0} and {1};
    # layer 1 {2, 1} and none
    assert wc["uniq_src"].tolist() == [[4, 1], [2, 0]]


def ctx_for(flat, d=8, H=4, C=3, traced=None):
    cell = types.SimpleNamespace(config={"feat_dim": d, "hidden_dim": H,
                                         "num_classes": C, "num_layers": 2},
                                 traffic={})
    s = summary.epoch_summary([flat], [np.array([30, 31])])
    rep = types.SimpleNamespace(epoch=0, miss_lanes=np.array([7]),
                                wire_rows=11,
                                exposed_stage_s=0.5, copy_s=0.25,
                                stage_s=0.0)
    return Context(cell, {"fp32_flop_per_s": 1e9, "hbm_bytes_per_s": 1e6},
                   [rep, rep], 2.0, 3000, lambda e: s, traced, [0])


def test_train_step_mfu_by_hand():
    d, H, C = 8, 4, 3
    # batch 0: n0 = 3, n1 = 2, E0 = 5, E1 = 2; batch 1: 1, 1, 2, 0
    ops = sum(8 * n0 * d * H + 12 * n1 * H * C + E0 * d + n0 * d
              + 2 * E1 * H + n1 * H
              for n0, n1, E0, E1 in ((3, 2, 5, 2), (1, 1, 2, 0)))
    ctx = ctx_for(hand_flat(), d, H, C)
    got = load_reader(ROOT, "train_step_mfu").read(ctx, {})
    # two window epochs over 2 s against 1e9 operations a second
    assert got == pytest.approx(100.0 * 2 * ops / 2.0 / 1e9)


def test_roofline_bytes_by_hand():
    d, H = 8, 4
    fwd = (4 * d * 4 + 3 * d * 4 + 5 * 5 + 2 * H * 4 + 2 * H * 4 + 2 * 5
           + 1 * d * 4 + 1 * d * 4 + 2 * 5 + 1 * H * 4)
    bwd = (2 * H * 4 + 2 * 5 + 3 * H * 4) + (1 * H * 4 + 0 + 1 * H * 4)
    asm = (2 * 4 * d * 4 + 4 * 4) + (2 * 2 * d * 4 + 2 * 4) + 2 * 2 * 4
    ev = [DeviceEvent("void gather_agg_kernel<4, 8>(float const*)", 0,
                      1000, ""),
          DeviceEvent("order_kernel(int const*)", 1000, 1500, ""),
          DeviceEvent("void sum_kernel<4>(float const*)", 1500, 2000, ""),
          DeviceEvent("assemble_kernel(float const*)", 2000, 4000, ""),
          DeviceEvent("void at::native::reduce_kernel<512>(x)", 4000, 9000,
                      "aten::sum")]
    tr = TraceData(window_s=1e-5, events=ev)
    ctx = ctx_for(hand_flat(), traced=tr)
    names = {"agg_fwd_roofline": (["gather_agg_kernel"], fwd, 1e-6),
             "agg_bwd_roofline": (["order_kernel", "sum_kernel"], bwd, 1e-6),
             "assemble_roofline": (["assemble_kernel"], asm, 2e-6)}
    for metric, (kernels, nbytes, secs) in names.items():
        got = load_reader(ROOT, metric).read(ctx, {"trace_names": kernels})
        assert got == pytest.approx(100.0 * nbytes / 1e6 / secs), metric
    idle = load_reader(ROOT, "device_idle_share").read(ctx, {})
    assert idle == pytest.approx(100.0 * (1 - 9000e-9 / 1e-5))
    # over the window's untraced pass of the same work where there is one
    ctx.window_pass_s = 2e-5
    idle = load_reader(ROOT, "device_idle_share").read(ctx, {})
    assert idle == pytest.approx(100.0 * (1 - 9000e-9 / 2e-5))
    (gap, secs), = tr.idle_gaps(0, 10000)
    assert gap == "after the last device activity"
    assert secs == pytest.approx(1000e-9)
    assert base_name(ev[3].name) == "assemble_kernel"


def test_window_readers_and_rates():
    ctx = ctx_for(hand_flat())
    assert load_reader(ROOT, "exposed_stage_ms").read(ctx, {}) == 500.0
    assert load_reader(ROOT, "boundary_copy_ms").read(ctx, {}) == 250.0
    assert load_reader(ROOT, "stage_ms").read(ctx, {}) is None
    assert load_reader(ROOT, "miss_lanes_per_kseed").read(ctx, {}) == \
        pytest.approx(14 / 3.0)
    assert load_reader(ROOT, "remote_rows_per_kseed").read(ctx, {}) == \
        pytest.approx(22 / 3.0)
    cell = load_cell(load_manifest()["workloads"][0]["name"])
    out = read_metrics(cell, ctx, False, 2.0, 3000)
    assert out == {"train_seeds_per_s": {"value": 1500.0,
                                         "unit": "seeds/s"}}


def test_host_readings_over_a_span():
    a = hostinfo.snapshot()
    sum(i * i for i in range(200_000))
    d = hostinfo.delta(a, hostinfo.snapshot())
    assert d["wall_s"] > 0 and d["cpu_s"] >= 0
    assert d["ctx_vol"] >= 0 and d["ctx_invol"] >= 0
    assert all(d[k] >= 0 for k in ("machine_busy_s", "machine_steal_s")
               if k in d)
    assert hostinfo.layout()["cpus"] >= 1
