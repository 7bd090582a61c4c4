"""A whole run of a tiny cell on the CPU (the program's plain PyTorch
path) against the reference, and the same run with the timed path
broken underneath, once for each fault the cells can have: each must
come out not correct. Also: a cell, a traffic mix and a metric added by
new files only, and no JAX in a run's process."""
import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness, testing
from perfbench.manifest import ROOT


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(root, cell, trace=False, seconds=0.3):
    return harness.run_cell(cell, 2 ** 31 + 977, seconds, trace,
                            torch.device("cpu"), time.perf_counter(), root)


@pytest.fixture(scope="module")
def ahead(tmp_path_factory):
    return testing.tiny_root(tmp_path_factory.mktemp("ahead"), "ahead")


@pytest.mark.parametrize("schedule", ["ahead", "lazy"])
def test_tiny_run_matches_reference(schedule, tmp_path, few_threads):
    root, cell = testing.tiny_root(tmp_path, schedule)
    res = run_tiny(root, cell, trace=(schedule == "lazy"))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    for k in ("partition_mismatch", "schedule_mismatch", "hot_set_mismatch",
              "miss_rows_gap", "wire_rows_short"):
        assert res["checks"][k]["value"] == 0.0
    assert res["attempted"] > 0 and res["failed"] == 0
    # whole passes of the job, the window ending at the first pass end
    # past its seconds
    E = testing.TINY["epochs"]
    assert res["info"]["window_s"] >= 0.3
    assert [n for n, _ in res["info"]["passes"]] == [E] * len(
        res["info"]["passes"])
    if schedule == "ahead":
        m = res["metrics"]
        assert set(m) == {"train_seeds_per_s", "setup_s"}
        assert m["train_seeds_per_s"]["value"] > 0
    else:   # CPU: no device trace, so only the host-read metrics
        # (stage_ms only where a pass of the short window staged an epoch)
        assert {"exposed_stage_ms", "boundary_copy_ms",
                "remote_rows_per_kseed", "miss_lanes_per_kseed",
                "train_step_mfu"} <= set(res["metrics"]) <= {
            "exposed_stage_ms", "boundary_copy_ms", "stage_ms",
            "remote_rows_per_kseed", "miss_lanes_per_kseed",
            "train_step_mfu"}


def _unchanged_state(monkeypatch):
    from repro_torch.train import optim
    monkeypatch.setattr(optim.AdamW, "update",
                        lambda self, grads, state, params, **kw:
                        (params, state))


def _state_restarted_each_call(monkeypatch):
    from repro_torch.dist import runner
    orig = runner._DeviceRunnerBase.run

    def restarted(self, params=None, opt_state=None, start_epoch=0,
                  stop_epoch=None):
        if start_epoch > 0:     # AdamW's moments and step count dropped
            opt_state = self.opt.init(params)
        return orig(self, params, opt_state, start_epoch, stop_epoch)
    monkeypatch.setattr(runner._DeviceRunnerBase, "run", restarted)


def _half_batch(monkeypatch):
    from repro_torch.models import gnn
    orig = gnn.loss_fn

    def half(cfg, params, feats, es, ed, em, labels, seed_mask):
        sm = seed_mask.clone()
        on = torch.nonzero(sm).flatten()
        sm[on[on.numel() // 2:]] = False
        return orig(cfg, params, feats, es, ed, em, labels, sm)
    monkeypatch.setattr(gnn, "loss_fn", half)


def _no_exchange(monkeypatch):
    from repro_torch.dist import gnn_step
    orig = gnn_step.pull_features

    def none(*args, **kw):
        return orig(*args, **kw).zero_()
    monkeypatch.setattr(gnn_step, "pull_features", none)


def _altered_schedule(monkeypatch):
    from repro_torch.graph import device_sampler
    orig = device_sampler.sample_epoch_batched_device

    def altered(*args, **kw):
        flat = orig(*args, **kw)
        if flat.num_batches:
            flat.edge_src[1][0] = (flat.edge_src[1][0] + 1) % 2
        return flat
    monkeypatch.setattr(device_sampler, "sample_epoch_batched_device",
                        altered)


def _altered_rows(monkeypatch):
    from repro_torch.dist import runner
    orig = runner._DeviceRunnerBase._collate_and_account

    def altered(self, *args, **kw):
        out = orig(self, *args, **kw)
        out["lanes"] = out["lanes"] - 1
        return out
    monkeypatch.setattr(runner._DeviceRunnerBase, "_collate_and_account",
                        altered)


@pytest.mark.parametrize("fault, fails", [
    (_unchanged_state, "update_gap"),
    (_state_restarted_each_call, "update_diff"),
    (_half_batch, "loss_gap"),
    (_no_exchange, "loss_gap"),
    (_altered_schedule, "schedule_mismatch"),
    (_altered_rows, "miss_rows_gap"),
], ids=lambda x: getattr(x, "__name__", x))
def test_broken_timed_path_is_not_correct(fault, fails, ahead, monkeypatch,
                                          few_threads):
    root, cell = ahead
    fault(monkeypatch)
    res = run_tiny(root, cell)
    assert not res["correct"]
    c = res["checks"][fails]
    assert c["value"] > c["limit"], res["checks"]


def test_new_cell_traffic_and_metric_from_new_files(tmp_path, few_threads):
    root, _ = testing.tiny_root(tmp_path)
    (root / "perfbench/readers/seeds_per_epoch.py").write_text(
        "def read(ctx, spec):\n"
        "    return ctx.seeds / max(len(ctx.reports), 1) * spec['scale']\n")
    (root / "perfbench/metrics/seeds_per_epoch.json").write_text(
        json.dumps({"reader": "seeds_per_epoch", "scale": 1.0}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "seeds_per_epoch", "unit": "seeds",
                             "better": "higher", "source": "host_clock",
                             "layer": "runner", "moves": "train_seeds_per_s",
                             "workloads": []})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = testing.add_cell(
        root, "sage-tiny2", "b32",
        config_over=dict(testing.TINY, hidden_dim=16),
        traffic_spec={"batch_size": 32, "schedule": "ahead",
                      "compiler": "device", "check_epochs": 2},
        limits=testing.TINY_LIMITS, metrics=["seeds_per_epoch"])
    res = run_tiny(root, cell, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"seeds_per_epoch"}
    assert res["metrics"]["seeds_per_epoch"]["value"] > 0
    assert res["info"]["check_epochs"][0] == 0
    assert len(res["info"]["check_epochs"]) == 3


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_sources_import_no_jax():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (path, n)


def test_a_run_loads_no_jax(tmp_path):
    """A fresh process runs a tiny cell as ``run.py`` does and reports the
    top-level names of what it loaded."""
    root, cell = testing.tiny_root(tmp_path)
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from perfbench import harness\n"
        "from perfbench.run import forbidden_modules\n"
        f"r = harness.run_cell({cell!r}, 5, 0.2, False, "
        f"torch.device('cpu'), time.perf_counter(), {str(root)!r})\n"
        "print(r['correct'], forbidden_modules(), "
        "sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "True [] ['repro_torch']"


def test_forbidden_names_compared_whole():
    from perfbench.run import FORBIDDEN as names
    assert "repro" in names and "repro_torch" not in names
    assert np.all(["repro_torch".split(".")[0] != n for n in names])
