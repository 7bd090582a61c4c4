"""The port's paper-metrics campaign (``repro_torch.eval``) against the
JAX package's (``repro.eval``), on the CPU.

The copies (``spec``, ``differential``, ``report``, ``replay``) give the
reference's results on the same inputs: every grid, every check over the
same ``CellResult`` dicts (perturbed ones included), the same reports
less their time stamps, the same validator verdicts on damaged reports
and the same replayed byte counts.

The cells: the ``--fast`` grid's host and device cells and the fault
grid's cells run in both packages from the same initial parameters (the
JAX ``init_params`` output carried over with ``params_from_numpy``). The
reference's device cells run in one subprocess with 4 emulated devices
(``repro.eval.cells.run_device_cells``), the port's in process on the
CPU. Every integer field is bit-equal; losses and accuracies agree
within the reference's cross-program tolerance (``rtol=1e-4,
atol=1e-5``). The port's device cells count one static input shape
(``trace_count`` 1); the reference's count is not asserted (2 under
jax 0.9.0). The gcn and dgl-random host cells run in both packages too.
"""
import copy
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import repro.eval as J
import repro_torch.eval as T
from repro.eval.replay import (replay_device_bytes as j_replay,
                               replay_topology_bytes as j_replay_topo)
from repro.models import GNNConfig as JConfig, init_params as j_init
from repro_torch.eval import cells as t_cells
from repro_torch.eval.campaign import (run_campaign as t_run_campaign,
                                       run_fault_campaign)
from repro_torch.eval.replay import (replay_device_bytes as t_replay,
                                     replay_topology_bytes as t_replay_topo)
from repro_torch.models.gnn import params_from_numpy
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
#: every field of a cell that no clock and no float sum decides
EXACT = ("spec", "feat_dim", "itemsize", "workers_run", "num_steps",
         "warm_steps", "rpc_count", "remote_requests", "cache_hits",
         "cache_misses", "hit_rate", "remote_bytes", "vector_pull_bytes",
         "payload_bytes", "miss_matrix", "wire_rows", "device_cache_bytes",
         "request_bytes", "intra_misses", "inter_misses", "intra_bytes",
         "inter_bytes", "intra_wire_rows", "inter_wire_rows",
         "degraded_epochs", "stage_retries", "pull_retries",
         "prefetch_retries", "csec_degraded", "spill_rebuilds",
         "deadline_overruns", "fault_events")
GRIDS = ("fast_grid", "full_grid", "fault_grid", "tiny_host_grid")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny cells gain nothing from intra-op threads, and beside
    other test processes those threads only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed, device):
    """The JAX package's initial parameters for the port's ``cfg``."""
    jcfg = JConfig(kind=cfg.kind, in_dim=cfg.in_dim,
                   hidden_dim=cfg.hidden_dim, num_classes=cfg.num_classes,
                   num_layers=cfg.num_layers)
    tree = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(seed)))
    return params_from_numpy(tree, device)


@pytest.fixture(scope="module")
def jax_init():
    """Every port cell in the scope starts from the JAX parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cells, "initial_params", _jax_params)
        yield


@pytest.fixture(scope="module")
def ref_device_cells():
    """The reference's device cells of the fast and fault grids (one
    subprocess, 4 emulated devices)."""
    specs = J.fast_grid().device_cells() + J.fault_grid().device_cells()
    return [c.to_dict() for c in J.run_device_cells(specs)]


@pytest.fixture(scope="module")
def port_fast(jax_init, tmp_path_factory):
    out = tmp_path_factory.mktemp("campaign") / "BENCH_torch_paper.json"
    report = t_run_campaign(T.fast_grid(), out_path=str(out), device="cpu")
    with open(out) as f:
        return report, json.load(f)


@pytest.fixture(scope="module")
def port_fault(jax_init):
    return run_fault_campaign(device="cpu")


@pytest.fixture(scope="module")
def ref_host_cells():
    """The reference's host cells of the fast and fault grids."""
    specs = J.fast_grid().host_cells() + J.fault_grid().host_cells()
    return [J.run_host_cell(c).to_dict() for c in specs]


def _by_label(dicts):
    return {J.CellSpec.from_dict(d["spec"]).label(): d for d in dicts}


def _same_cell(t, j):
    for k in EXACT:
        assert t[k] == j[k], (k, t[k], j[k])
    assert len(t["losses"]) == len(j["losses"]) > 0
    np.testing.assert_allclose(t["losses"], j["losses"], **TOL)
    np.testing.assert_allclose(t["accs"], j["accs"], **TOL)
    assert set(t["energy"]) == set(j["energy"])


# ---------------------------------------------------------------------------
# the copies: spec, differential, report, replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", GRIDS)
def test_grids_equal_reference(name):
    tg, jg = getattr(T, name)(), getattr(J, name)()
    assert tg.name == jg.name and len(tg.cells) == len(jg.cells)
    for tc, jc in zip(tg.cells, jg.cells):
        assert tc.to_dict() == jc.to_dict()
        assert tc.scenario_key() == jc.scenario_key()
        assert tc.label() == jc.label()
        assert (tc.is_rapid, tc.effective_compiler, tc.partition_method,
                tc.effective_fanouts) == (jc.is_rapid,
                                          jc.effective_compiler,
                                          jc.partition_method,
                                          jc.effective_fanouts)
        assert T.CellSpec.from_dict(jc.to_dict()) == tc
    assert T.HOST_SYSTEMS == J.HOST_SYSTEMS
    assert T.DEVICE_SYSTEMS == J.DEVICE_SYSTEMS


@pytest.mark.parametrize("bad", [
    dict(backend="tpu"), dict(backend="device", system="gcn"),
    dict(schedule_compiler="fast"), dict(schedule_backend="gpu"),
    dict(fault_profile="no-such-profile"), dict(topology="2x2"),
    dict(backend="device", topology="3x2")])
def test_spec_validation_matches_reference(bad):
    kw = dict(backend="host", system="rapidgnn", dataset="tiny",
              batch_size=16, workers=4, n_hot=64, epochs=2)
    kw.update(bad)
    with pytest.raises(ValueError):
        J.CellSpec(**kw)
    with pytest.raises(ValueError):
        T.CellSpec(**kw)


def _perturb(kind, cells):
    """The perturbations of ``tests/test_eval_campaign.py``, on a list of
    cell dicts (host rapid, host baseline, then device cells)."""
    if kind == "rpc":
        cells[0]["rpc_count"] += 1
    elif kind == "miss_matrix":
        cells[1]["miss_matrix"][0][0] += 1
    elif kind == "loss":
        next(c for c in cells if c["spec"]["system"] == "rapidgnn"
             and c["spec"]["backend"] == "host")["losses"][3] += 0.1
    elif kind == "lane":
        next(c for c in cells
             if c["spec"]["backend"] == "device")["miss_matrix"][0][0] += 1
    elif kind == "trace":
        for c in cells:
            if c["spec"]["backend"] == "device":
                c["trace_count"] = 2
    elif kind == "topology":
        next(c for c in cells if c["spec"]["topology"] == "2x2")[
            "losses"][0] += 0.25
    return cells


@pytest.mark.parametrize("kind", ["none", "rpc", "miss_matrix", "loss",
                                  "lane", "trace", "topology"])
def test_differential_copies_agree(kind, port_fast):
    """``verify_cells`` of both packages over the same (perturbed) cell
    dicts gives the same checks, statuses and details."""
    dicts = _perturb(kind, copy.deepcopy(port_fast[1]["cells"]))
    tc = [T.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    jc = [J.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    tr = [c.to_dict() for c in T.verify_cells(tc)]
    jr = [c.to_dict() for c in J.verify_cells(jc)]
    assert tr == jr
    assert any(c["status"] == "FAIL" for c in tr) == (kind != "none")


def _strip(report):
    return {k: v for k, v in report.items() if k != "created_unix"}


@pytest.mark.parametrize("damage", ["none", "pairs", "miss_matrix",
                                    "schema", "checks"])
def test_report_copies_agree(damage, port_fast):
    """``derive_pairs``, ``build_report`` (less ``created_unix``) and
    ``validate_report`` agree over the same cells and checks."""
    dicts = port_fast[1]["cells"]
    tc = [T.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    jc = [J.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    assert T.derive_pairs(tc) == J.derive_pairs(jc)
    tr = T.build_report("fast", tc, T.verify_cells(tc))
    jr = J.build_report("fast", jc, J.verify_cells(jc))
    assert _strip(tr) == _strip(jr)
    bad = json.loads(json.dumps(jr))
    if damage == "pairs":
        del bad["pairs"]
    elif damage == "miss_matrix":
        del bad["cells"][0]["miss_matrix"]
    elif damage == "schema":
        bad["schema"] = "rapidgnn.bench_paper/v1"
    elif damage == "checks":
        bad["differential"][0]["status"] = "FAIL"
    assert T.validate_report(bad) == J.validate_report(bad)
    assert bool(T.validate_report(bad)) == (damage not in ("none",
                                                           "checks"))
    assert T.SCHEMA == J.SCHEMA and T.FAULT_SCHEMA == J.FAULT_SCHEMA
    assert T.PAPER_TARGETS == J.PAPER_TARGETS


@pytest.mark.parametrize("damage", ["none", "diverged", "quiet",
                                    "no_degraded"])
def test_fault_report_copies_agree(damage, port_fault):
    """``verify_fault_pairs``, ``build_fault_report`` and
    ``validate_fault_report`` agree over the port's fault cells, with a
    diverged recovered curve, a plan that never fired and a campaign
    where nothing degrades."""
    dicts = copy.deepcopy(port_fault["cells"])
    if damage == "diverged":
        next(d for d in dicts if d["spec"]["fault_profile"] ==
             "csec-loss")["losses"][0] += 0.25
    elif damage == "quiet":
        next(d for d in dicts if d["spec"]["fault_profile"] ==
             "pull-flaky")["fault_events"] = 0
    tc = [T.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    jc = [J.CellResult.from_dict(copy.deepcopy(d)) for d in dicts]
    tchk = T.verify_cells(tc) + T.verify_fault_pairs(tc)
    jchk = J.verify_cells(jc) + J.verify_fault_pairs(jc)
    assert [c.to_dict() for c in tchk] == [c.to_dict() for c in jchk]
    tr = _strip(T.build_fault_report("fault", tc, tchk))
    jr = _strip(J.build_fault_report("fault", jc, jchk))
    assert tr == jr
    if damage == "no_degraded":
        for r in jr["fault_summary"]:
            r["degraded_epochs"] = 0
    assert T.validate_fault_report(jr) == J.validate_fault_report(jr)
    assert bool(J.validate_fault_report(jr)) == (damage == "no_degraded")
    assert jr["all_checks_pass"] == (damage in ("none", "no_degraded"))


def test_serve_report_copies_agree():
    from repro.eval.report import (build_serve_report as j_build,
                                   validate_serve_report as j_validate)
    from repro_torch.eval.report import (build_serve_report as t_build,
                                         validate_serve_report as t_validate)
    lanes = [{"lane": name, "fault_profile": prof, "requests": 16,
              "served": 16 - shed, "shed": shed, "errors": 0,
              "latency_ms": {"p50": p50, "p99": 2 * p50},
              "health": {"trace_count": 1}}
             for name, prof, shed, p50 in (
                 ("clean", "none", 0, 1.5),
                 ("faulted", "serve-pull-flaky", 2, 2.5))]
    config = {"dataset": "tiny", "requests": 16}
    for bound in (5.0, 1.2):
        tr, jr = t_build(config, lanes, bound), j_build(config, lanes, bound)
        assert _strip(tr) == _strip(jr)
        assert t_validate(jr) == j_validate(jr)
        del jr["lanes"][0]["latency_ms"]
        assert t_validate(jr) == j_validate(jr) != []


@pytest.mark.parametrize("kw", [
    dict(dataset="tiny", batch_size=16, workers=4, epochs=2, n_hot=64,
         fanouts=(5, 5), partition="greedy"),
    dict(dataset="tiny", batch_size=32, workers=2, epochs=1, n_hot=16,
         fanouts=(3, 3), partition="random", worker=1)])
def test_replay_device_bytes_equal(kw):
    assert t_replay(**kw) == j_replay(**kw)


@pytest.mark.parametrize("dcn_bias", [0.0, 2.0])
def test_replay_topology_bytes_equal(dcn_bias):
    kw = dict(dataset="tiny", batch_size=16, workers=4, epochs=2,
              n_hot=64, hosts=2, fanouts=(5, 5), partition="greedy",
              dcn_bias=dcn_bias)
    assert t_replay_topo(**kw) == j_replay_topo(**kw)


# ---------------------------------------------------------------------------
# the cells against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(2))
def test_fast_host_cells_match_reference(i, port_fast, ref_host_cells):
    t = [d for d in port_fast[1]["cells"]
         if d["spec"]["backend"] == "host"][i]
    _same_cell(t, _by_label(ref_host_cells)[
        J.CellSpec.from_dict(t["spec"]).label()])


@pytest.mark.parametrize("i", range(4))
def test_fast_device_cells_match_reference(i, port_fast, ref_device_cells):
    """Lanes, wire rows, the tier split, request/payload/VectorPull
    bytes bit-equal; losses within tolerance; the port traces once."""
    t = [d for d in port_fast[1]["cells"]
         if d["spec"]["backend"] == "device"][i]
    j = _by_label(ref_device_cells)[J.CellSpec.from_dict(t["spec"]).label()]
    _same_cell(t, j)
    assert [e["miss_lanes"] for e in t["epoch_metrics"]] == \
        [e["miss_lanes"] for e in j["epoch_metrics"]]
    assert sorted(t["epoch_metrics"][0]) == sorted(j["epoch_metrics"][0])
    assert t["trace_count"] == 1 and j["trace_count"] >= 1


@pytest.mark.parametrize("system", ["gcn", "dgl-random"])
def test_other_host_systems_match_reference(system, jax_init):
    spec = dict(backend="host", system=system, dataset="tiny",
                batch_size=16, workers=4, n_hot=64, epochs=2, seed=42,
                fanouts=(5, 5), partition="greedy", net_enabled=False)
    t = t_cells.run_host_cell(T.CellSpec(**spec), device="cpu").to_dict()
    j = J.run_host_cell(J.CellSpec(**spec)).to_dict()
    _same_cell(t, j)


def test_gcn_blocks_are_dst_major_and_fanout_regular():
    """The gcn system's (50, 50) blocks keep the layout the
    ``gather_agg`` kernel reads: every dst row owns ``fanout``
    contiguous edges, in dst order."""
    from repro_torch.core import build_schedule, collate
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph

    spec = T.CellSpec(backend="host", system="gcn", dataset="tiny",
                      batch_size=16, workers=4, n_hot=0, epochs=1,
                      partition="greedy")
    g = load_dataset("tiny")
    pg = partition_graph(g, 4, spec.partition_method)
    fo = spec.effective_fanouts
    sampler = KHopSampler(g, fanouts=list(fo), batch_size=16)
    ws = build_schedule(sampler, pg, worker=0, s0=42, num_epochs=1,
                        n_hot=0)
    m_max, edge_max = ws.pad_bounds()
    assert all(e % f == 0 for e, f in zip(edge_max, fo))
    for b in ws.epoch(0).batches[:4]:
        cb = collate(b, g.labels, 16, m_max, edge_max)
        for l, f in enumerate(fo):
            nd = int(cb.num_dst[l])
            np.testing.assert_array_equal(cb.edge_dst[l][:nd * f],
                                          np.repeat(np.arange(nd), f))
            assert not cb.edge_mask[l][nd * f:].any()


@pytest.mark.parametrize("i", range(7))
def test_fault_cells_match_reference(i, port_fault, ref_host_cells,
                                     ref_device_cells):
    t = port_fault["cells"][i]
    j = _by_label(ref_host_cells + ref_device_cells)[
        J.CellSpec.from_dict(t["spec"]).label()]
    _same_cell(t, j)


def test_cells_cross_packages_as_json(port_fast):
    """A port cell's JSON loads into the reference's ``CellResult`` and
    back, unchanged, and the other way round."""
    for d in port_fast[1]["cells"]:
        back = json.loads(json.dumps(J.CellResult.from_dict(d).to_dict()))
        assert back == d
        assert T.CellResult.from_dict(back).to_dict() == d
        for k, v in d.items():
            assert not isinstance(v, np.generic), k


# ---------------------------------------------------------------------------
# the port's campaign end to end
# ---------------------------------------------------------------------------

def test_fast_campaign_passes_every_check(port_fast):
    report, loaded = port_fast
    assert J.validate_report(loaded) == [] == T.validate_report(report)
    assert report["all_checks_pass"], T.failures(
        [T.CheckResult(**c) for c in report["differential"]])
    ran = {c["check"] for c in report["differential"]}
    assert {"miss_parity", "payload_bytes", "vector_pull_bytes",
            "fetch_not_more", "loss_agreement", "one_compilation",
            "topology_loss_parity"} <= ran
    assert {c["spec"]["backend"] for c in report["cells"]} == \
        {"host", "device"}
    assert [p["fetch_reduction_x"] for p in report["pairs"]] == \
        [2.3147] * 3


def test_fault_campaign_passes_with_a_degraded_cell(port_fault):
    assert port_fault["all_checks_pass"]
    assert T.validate_fault_report(port_fault) == []
    assert any(r["degraded_epochs"] > 0
               for r in port_fault["fault_summary"])


def _cli(*args):
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.eval.campaign", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_fast_campaign_exits_zero(tmp_path):
    p = _cli("--fast", "--device", "cpu", "--out",
             str(tmp_path / "out.json"))
    assert p.returncode == 0, p.stdout + p.stderr
    assert "differential: 45 passed, 0 failed" in p.stdout
    assert "modelled energy_total_ratio" in p.stdout


def test_cli_inject_miscount_exits_nonzero(tmp_path):
    p = _cli("--fast", "--host-only", "--device", "cpu",
             "--inject-miscount", "--out", str(tmp_path / "out.json"))
    assert p.returncode == 1, p.stdout + p.stderr
    assert "[inject] perturbed counters" in p.stdout
    assert "FAIL bytes_identity" in p.stdout


def test_campaign_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run_campaign(T.tiny_host_grid())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cells.run_device_cells(T.fast_grid().device_cells())


def test_device_schedule_backend_is_bit_equal(port_fast):
    """``schedule_backend="device"`` (the device compiler, lazy device
    cells rebuilt in the staging thread) gives every cell's integer
    fields and loss curve bit for bit."""
    spec = T.CampaignSpec(
        name="fast-device",
        cells=tuple(dataclasses.replace(c, schedule_backend="device")
                    for c in T.fast_grid().cells))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cells, "initial_params", _jax_params)
        report = t_run_campaign(spec, device="cpu")
    assert report["all_checks_pass"]
    for a, b in zip(report["cells"], port_fast[1]["cells"]):
        for k in EXACT:
            if k != "spec":
                assert a[k] == b[k], k
        assert a["losses"] == b["losses"]
