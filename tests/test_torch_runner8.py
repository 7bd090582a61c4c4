"""The port's multi-epoch device runners at the paper's 8 workers, flat
and on two hosts of four (``2x4``), against the JAX runners on the CPU.

The JAX runners run in one subprocess with 8 emulated devices
(``tests/_torch_runner_ref.py OUT.npz 8``); both packages run the
``tiny`` graph over 8 greedy parts, B = 16, GraphSAGE hidden 32, fan-outs
(5, 5), 3 epochs, from the same initial parameters. Losses, accuracies
and final parameters agree within ``rtol=1e-4, atol=1e-5``; miss lanes,
their two tiers and the wire rows are bit-equal. Within the port the
``2x4`` curves are the flat ones bit for bit, both tiers carry rows and
they add up to the flat lanes.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import build_schedule
from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                              DeviceView, Topology, assert_host_parity,
                              make_mesh)
from repro_torch.graph import KHopSampler, load_dataset, partition_graph
from repro_torch.models.gnn import (GNNConfig, params_from_numpy,
                                    params_to_numpy)
from repro_torch.train import AdamW
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
#: the reference script's settings (tests/_torch_runner_ref.py) at P = 8
P_, B, EPOCHS, N_HOT, HIDDEN, FANOUTS, S0, LR = 8, 16, 3, 64, 32, (5, 5), 7, 3e-3
HIER = "2x4"
RUNS = [("rapid", "flat"), ("rapid", HIER), ("baseline", "flat"),
        ("baseline", HIER)]
LANE_FIELDS = ("miss_lanes", "intra_lanes", "inter_lanes", "wire_rows",
               "intra_wire_rows", "inter_wire_rows", "steps")


@pytest.fixture(scope="module")
def jax_runner_ref(tmp_path_factory):
    """The JAX runners' reports (8 emulated devices) from one
    subprocess."""
    out = tmp_path_factory.mktemp("jax_runner8") / "ref.npz"
    env = capped_env(f"--xla_force_host_platform_device_count={P_}",
                     PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable,
                        str(REPO / "tests" / "_torch_runner_ref.py"),
                        str(out), str(P_)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=400)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(out))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny runs gain nothing from intra-op threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    sampler = KHopSampler(g, fanouts=list(FANOUTS), batch_size=B)
    ws = [build_schedule(sampler, pg, worker=w, s0=S0, num_epochs=EPOCHS,
                         n_hot=N_HOT) for w in range(P_)]
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes, num_layers=2,
                    fanouts=FANOUTS, agg_backend="kernel")
    return g, pg, ws, DeviceView.build(pg), cfg


@pytest.fixture(scope="module")
def runs(world, jax_runner_ref):
    """{(kind, layout): (runner, reports)}, each from the JAX runners'
    initial parameters."""
    g, _, ws, dv, cfg = world
    p0 = params_from_numpy({"layers": [
        {k: jax_runner_ref[f"init_{l}_{k}"] for k in ("w_self", "w_neigh",
                                                      "b")}
        for l in range(2)]}, CPU)
    out = {}
    for kind, layout in RUNS:
        topo = None if layout == "flat" else Topology.parse(layout, P_)
        mesh = (make_mesh((P_,), ("data",), device=CPU) if topo is None
                else topo.make_mesh(CPU))
        cls = DeviceRapidGNNRunner if kind == "rapid" else \
            DeviceBaselineRunner
        runner = cls(ws, dv, cfg, AdamW(lr=LR), mesh, B, g.labels,
                     topology=topo)
        out[(kind, layout)] = runner, runner.run(params=p0)
    return out


@pytest.mark.parametrize("kind,layout", RUNS)
def test_runner_at_8_workers_matches_jax(world, jax_runner_ref, runs, kind,
                                         layout):
    ref, run = jax_runner_ref, f"{kind}_{layout}"
    runner, reports = runs[(kind, layout)]
    assert runner.trace_count == 1
    assert [r.epoch for r in reports] == list(range(EPOCHS))
    for r in reports:
        d = r.to_dict()
        assert sorted(d) == list(ref[f"{run}_keys"])
        for f in LANE_FIELDS:
            np.testing.assert_array_equal(np.asarray(d[f]),
                                          ref[f"{run}_{r.epoch}_{f}"],
                                          err_msg=f)
        for f in ("losses", "accs"):
            np.testing.assert_allclose(getattr(r, f),
                                       ref[f"{run}_{r.epoch}_{f}"], **TOL)
    for l, layer in enumerate(params_to_numpy(runner.params)["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(v, ref[f"{run}_final_{l}_{k}"], **TOL)
    if kind == "rapid":
        _, pg, ws, _, _ = world
        assert_host_parity(ws, pg, B, reports)


@pytest.mark.parametrize("kind", ["rapid", "baseline"])
def test_2x4_curve_is_flat_bit_for_bit_with_both_tiers(runs, kind):
    (_, flat), (_, hier) = runs[(kind, "flat")], runs[(kind, HIER)]
    for f, h in zip(flat, hier):
        assert h.losses.tobytes() == f.losses.tobytes()
        np.testing.assert_array_equal(h.intra_lanes + h.inter_lanes,
                                      f.miss_lanes)
        assert h.intra_wire_rows + h.inter_wire_rows == h.wire_rows
    assert sum(h.inter_wire_rows for h in hier) > 0
    assert sum(h.intra_wire_rows for h in hier) > 0
