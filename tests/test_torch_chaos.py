"""The port's chaos sweep (``repro_torch.fault.chaos``) against the JAX
package's (``repro.fault.chaos``), on the CPU.

Train side: for every plan of ``run_chaos(seed=0, fast=True)`` -- the
nine named host profiles and two random plans -- the port's sweep fires
the same number of injections and ends the same way as the reference's
(``bit-equal`` to its own clean oracle, or the same typed error).

Serve side: the port's sweep passes (no failed plan) with one
``ServeProgram`` shared by every service, its ``trace_count`` 1. Per-run
counts (``ok``/``shed``/``typed``/``stale``) and fires are compared with
the reference only where two reference sweeps agree, since the warmer
runs on a clock.

Also: the checkpoint drill, the sweep's determinism within the port and
its CLI.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.fault.chaos import (HOST_SWEEP as J_HOST_SWEEP,
                               SERVE_SWEEP as J_SERVE_SWEEP,
                               run_chaos as j_run_chaos)
from repro_torch.fault import chaos as t_chaos
from repro_torch.fault.chaos import HOST_SWEEP, SERVE_SWEEP, run_chaos

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN_PLANS = list(HOST_SWEEP) + ["chaos-0", "chaos-1"]
SERVE_PLANS = list(SERVE_SWEEP) + ["serve-chaos-0", "serve-chaos-1"]
SERVE_COUNTS = ("fires", "ok", "shed", "typed", "stale")


def _quiet(_msg):
    pass


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_sweep():
    return run_chaos(seed=0, fast=True, log=_quiet, device="cpu")


@pytest.fixture(scope="module")
def ref_sweep():
    return j_run_chaos(seed=0, fast=True, log=_quiet)


@pytest.fixture(scope="module")
def ref_serve_again():
    return j_run_chaos(seed=0, fast=True, log=_quiet, serve_only=True)


def _runs(sweep):
    return {r["plan"]: r for r in sweep["runs"]}


def test_sweeps_cover_the_reference_profiles(port_sweep, ref_sweep):
    assert HOST_SWEEP == J_HOST_SWEEP and SERVE_SWEEP == J_SERVE_SWEEP
    assert list(_runs(port_sweep)) == list(_runs(ref_sweep)) == TRAIN_PLANS
    assert [r["plan"] for r in port_sweep["serve"]["runs"]] == SERVE_PLANS
    assert port_sweep["oracle_steps"] == ref_sweep["oracle_steps"]


@pytest.mark.parametrize("plan", TRAIN_PLANS)
def test_train_plan_matches_reference(plan, port_sweep, ref_sweep):
    t, j = _runs(port_sweep)[plan], _runs(ref_sweep)[plan]
    assert (t["fires"], t["outcome"]) == (j["fires"], j["outcome"])
    assert t["snapshot"] == j["snapshot"]
    assert t["outcome"] == "bit-equal" or t["outcome"].startswith("typed:")


@pytest.mark.parametrize("plan", SERVE_PLANS)
def test_serve_plan_matches_reference(plan, port_sweep, ref_sweep,
                                      ref_serve_again):
    """Counts the two reference sweeps agree on are the port's too."""
    t = {r["plan"]: r for r in port_sweep["serve"]["runs"]}[plan]
    j1 = {r["plan"]: r for r in ref_sweep["serve"]["runs"]}[plan]
    j2 = {r["plan"]: r for r in ref_serve_again["serve"]["runs"]}[plan]
    assert plan not in port_sweep["serve"]["failed_plans"]
    assert t["ok"] + t["shed"] + t["typed"] == 12
    stable = [k for k in SERVE_COUNTS if j1[k] == j2[k]]
    for k in stable:
        assert t[k] == j1[k], (k, t[k], j1[k])


def test_sweep_passes_with_one_shared_program(port_sweep):
    assert port_sweep["ok"], port_sweep["failed_plans"]
    assert port_sweep["failed_plans"] == []
    assert port_sweep["serve"]["ok"]
    assert port_sweep["serve"]["trace_count"] == 1
    assert port_sweep["checkpoint_drill"] is True
    stale = {r["plan"]: r for r in port_sweep["serve"]["runs"]}[
        "serve-warm-stale"]
    assert stale["stale"] > 0


def test_checkpoint_drill_passes():
    msgs = []
    assert t_chaos._checkpoint_drill(msgs.append)
    assert msgs == []


def test_train_sweep_is_deterministic_within_the_port():
    """Two fresh scenarios give the same oracle curve bit for bit, and a
    recovered plan's curve is bit-equal to it."""
    from repro_torch.fault import plan_from_profile

    a = t_chaos._Chaos(torch.device("cpu")).run(None)
    b = t_chaos._Chaos(torch.device("cpu"))
    assert a.tobytes() == b.run(None).tobytes()
    assert a.tobytes() == b.run(plan_from_profile("csec-loss",
                                                  seed=0)).tobytes()
    assert np.isfinite(a).all() and a.shape == (27,)


def test_chaos_needs_a_device_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos(seed=0, fast=True, log=_quiet)


def test_cli_serve_only_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.fault.chaos", "--fast",
         "--serve-only", "--device", "cpu"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "9 serve plans, 0 failures" in p.stdout
    assert "recovery FAILED" not in p.stdout
