"""The port's multi-epoch device runners, hierarchical topology and
run-state checkpoints against the JAX package, on the CPU.

Against the JAX runners (``tests/_torch_runner_ref.py``, one subprocess
with 4 emulated devices; the ``tiny`` graph, 4 greedy parts, B = 16,
3 epochs, the same initial parameters): ``DeviceRapidGNNRunner`` and
``DeviceBaselineRunner``, flat and ``2x2``, give losses and accuracies
within the reference's cross-program tolerance (``rtol=1e-4,
atol=1e-5``), equal lane and wire counts and the same ``to_dict`` keys.
The JAX runner's own ``trace_count`` is not asserted (it is 2 under jax
0.9.0); the port's is 1.

Within the port, bit for bit: two fresh runs, rapid vs baseline vs the
two-tier runs, the lazy schedule staged in the background vs the eager
one, a checkpointed resume, and every tolerated fault profile against
the clean curve. Also: the C_s -> C_sec swap against the stale-cache
counterfactual, uneven workers, host parity, run states crossing the
packages both ways, the topology arithmetic and two-tier plans against
the reference, and ``pull_shard_two_tier`` on 4 gloo ranks.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.core import build_schedule as j_build_schedule
from repro.dist.feature_a2a import (pack_pull_lanes_two_tier as
                                    j_pack_two_tier)
from repro.dist.gnn_step import (DeviceView as JDeviceView,
                                 collate_device_epoch as j_collate,
                                 epoch_k_max_split as j_k_split)
from repro.dist.topology import Topology as JTopology
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.models import GNNConfig as JConfig, init_params as j_init
from repro.train import AdamW as JAdamW
from repro.train.checkpoint import (_flatten as j_flatten,
                                    latest_step as j_latest_step,
                                    load_run_state as j_load_run_state,
                                    save_run_state as j_save_run_state)
from repro_torch.core import build_schedule
from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                              DeviceView, StagingError, Topology,
                              assert_host_parity, collate_device_epoch,
                              epoch_k_max, epoch_k_max_split, make_mesh,
                              pack_pull_lanes, pack_pull_lanes_two_tier,
                              pull_features, pull_features_two_tier)
from repro_torch.fault import (FaultPlan, InjectedCrash, active_plan,
                               plan_from_profile)
from repro_torch.graph import KHopSampler, load_dataset, partition_graph
from repro_torch.models.gnn import (GNNConfig, init_params,
                                    params_from_numpy, params_to_numpy)
from repro_torch.train import (AdamW, CheckpointCorruptError, latest_step,
                               load_run_state, save_run_state)
from repro_torch.train.checkpoint import _flatten as t_flatten
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
#: the reference script's settings (tests/_torch_runner_ref.py)
P_, B, EPOCHS, N_HOT, HIDDEN, FANOUTS, S0, LR = 4, 16, 3, 64, 32, (5, 5), 7, 3e-3
RUNS = [("rapid", "flat"), ("rapid", "2x2"), ("baseline", "flat"),
        ("baseline", "2x2")]
LANE_FIELDS = ("miss_lanes", "intra_lanes", "inter_lanes", "wire_rows",
               "intra_wire_rows", "inter_wire_rows", "steps")


@pytest.fixture(scope="module")
def jax_runner_ref(tmp_path_factory):
    """The JAX runners' reports (4 emulated devices) from one
    subprocess."""
    out = tmp_path_factory.mktemp("jax_runner") / "ref.npz"
    env = capped_env("--xla_force_host_platform_device_count=4",
                     PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable,
                        str(REPO / "tests" / "_torch_runner_ref.py"),
                        str(out)], env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(out))


def _world(g=None, epochs=EPOCHS, **schedule_kw):
    """The tiny graph's P = 4 run in the port: (graph, partition,
    schedules, device view, config)."""
    g = load_dataset("tiny") if g is None else g
    pg = partition_graph(g, P_, "greedy")
    sampler = KHopSampler(g, fanouts=list(FANOUTS), batch_size=B)
    ws = [build_schedule(sampler, pg, worker=w, s0=S0, num_epochs=epochs,
                         n_hot=N_HOT, **schedule_kw)
          for w in range(P_)]
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                    num_classes=g.num_classes, num_layers=2,
                    fanouts=FANOUTS, agg_backend="kernel")
    return g, pg, ws, DeviceView.build(pg), cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny runs gain nothing from intra-op threads, and beside other
    test processes those threads only oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    return _world()


def _runner(world, kind="rapid", layout="flat", **kw):
    g, _, ws, dv, cfg = world
    topo = None if layout == "flat" else Topology.parse(layout, P_)
    mesh = (make_mesh((P_,), ("data",), device=CPU) if topo is None
            else topo.make_mesh(CPU))
    cls = DeviceRapidGNNRunner if kind == "rapid" else DeviceBaselineRunner
    return cls(ws, dv, cfg, AdamW(lr=LR), mesh, B, g.labels, topology=topo,
               **kw)


def _curve(reports) -> np.ndarray:
    return np.concatenate([r.losses for r in reports])


def _bits(tree) -> dict:
    """{leaf path: bytes} of a parameter or optimizer-state tree."""
    return {k: np.asarray(v.detach().cpu().numpy() if isinstance(
        v, torch.Tensor) else v).tobytes() for k, v in t_flatten(tree).items()}


@pytest.fixture(scope="module")
def p0(jax_runner_ref):
    """The JAX runners' initial parameters, as the port's."""
    tree = {"layers": [{k: jax_runner_ref[f"init_{l}_{k}"] for k in
                        ("w_self", "w_neigh", "b")} for l in range(2)]}
    return params_from_numpy(tree, CPU)


@pytest.fixture(scope="module")
def runs(world, p0):
    """{(kind, layout): (runner, reports)} for the four runs, each from
    ``p0``."""
    out = {}
    for kind, layout in RUNS:
        runner = _runner(world, kind, layout)
        out[(kind, layout)] = runner, runner.run(params=p0)
    return out


@pytest.fixture(scope="module")
def clean(runs):
    """The clean rapid flat run."""
    return runs[("rapid", "flat")]


# ---------------------------------------------------------------------------
# against the JAX runners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,layout", RUNS)
def test_runner_matches_jax(world, jax_runner_ref, runs, kind, layout):
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
        assert r.degraded == 0 and r.stage_retries == 0
        assert r.copy_s > 0.0
    for l, layer in enumerate(params_to_numpy(runner.params)["layers"]):
        for k, v in layer.items():
            np.testing.assert_allclose(v, ref[f"{run}_final_{l}_{k}"], **TOL)
    if kind == "rapid":
        _, pg, ws, _, _ = world
        assert_host_parity(ws, pg, B, reports)
    assert reports[-1].losses[-1] < reports[0].losses[0]


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------

def test_runner_curves_bit_equal_and_deterministic(runs, clean, p0):
    base_runner, base = clean
    reports = {key: r for key, (_, r) in runs.items()}
    for key, r in reports.items():
        np.testing.assert_array_equal(_curve(r), _curve(base),
                                      err_msg=str(key))
    # a second run from a fresh world (graph, schedules, view, runner)
    again = _runner(_world())
    np.testing.assert_array_equal(_curve(again.run(params=p0)),
                                  _curve(base))
    assert _bits(again.params) == _bits(base_runner.params)
    assert _bits(again.opt_state) == _bits(base_runner.opt_state)
    # the two tiers split the flat lanes; padded rows decompose by tier
    for rf, rh in zip(reports[("rapid", "flat")],
                      reports[("rapid", "2x2")]):
        np.testing.assert_array_equal(rh.intra_lanes + rh.inter_lanes,
                                      rf.miss_lanes)
        np.testing.assert_array_equal(rh.miss_lanes, rf.miss_lanes)
        assert rh.intra_wire_rows + rh.inter_wire_rows == rh.wire_rows
        assert rh.intra_lanes.sum() > 0 and rh.inter_lanes.sum() > 0
        assert rf.inter_lanes.sum() == 0 and rf.inter_wire_rows == 0
    # no cache: every remote id rides the lanes, so never fewer
    for r, b in zip(reports[("rapid", "flat")],
                    reports[("baseline", "flat")]):
        assert (b.miss_lanes >= r.miss_lanes).all()


def test_swap_shrinks_epoch1_lanes(world, clean):
    """Epoch 1 collated against the swapped-in C_sec pulls fewer lanes
    than against epoch 0's C_s kept (the no-swap counterfactual)."""
    g, _, ws, dv, _ = world
    runner, reports = clean
    caches0 = [dv.remap_cache(w.epoch(0).cache_ids) for w in ws]
    es1 = [w.epoch(1) for w in ws]
    k_stale = max(runner.k_max, epoch_k_max(es1, caches0, dv))
    stale = collate_device_epoch(es1, caches0, dv, g.labels, B,
                                 runner.m_max, runner.edge_max, k_stale,
                                 runner.num_steps)
    assert reports[1].total_miss_lanes < int(stale["send_mask"].sum())


def test_uneven_workers():
    """Worker 2 trains on nothing, worker 3 on half a batch: fully
    masked steps, no lanes for worker 2, host parity, one shape key
    (the reference's ``tests/_uneven.py`` case)."""
    g = load_dataset("tiny")
    pg = partition_graph(g, P_, "greedy")
    tm = g.train_mask.copy()
    tm[pg.local_nodes[2]] = False
    l3 = pg.local_nodes[3]
    keep = l3[tm[l3]][:B // 2]
    tm[l3] = False
    tm[keep] = True
    world = _world(dataclasses.replace(g, train_mask=tm), epochs=2)
    _, pg, ws, _, _ = world
    assert ws[2].epoch(0).num_batches == 0
    assert ws[3].epoch(0).num_batches < ws[0].epoch(0).num_batches
    for layout in ("flat", "2x2"):
        runner = _runner(world, "rapid", layout)
        reports = runner.run()
        assert runner.trace_count == 1
        for r in reports:
            assert np.isfinite(r.losses).all()
            assert r.miss_lanes[2] == 0
        assert_host_parity(ws, pg, B, reports)


def test_lazy_device_schedule_staged_in_background(clean, p0):
    """Lazy schedules from the device compiler (its plain versions on
    the CPU) are rebuilt by the staging thread: the curve and lanes
    equal the eager run's, and the staging accounting is consistent."""
    lazy = _world(compiler="device", lazy=True, device=CPU)
    assert all(e is None for ws in lazy[2] for e in ws.epochs)
    runner = _runner(lazy)
    reports = runner.run(params=p0)
    _, base = clean
    np.testing.assert_array_equal(_curve(reports), _curve(base))
    np.testing.assert_array_equal(np.stack([r.miss_lanes for r in reports]),
                                  np.stack([r.miss_lanes for r in base]))
    assert runner.trace_count == 1
    assert runner.stage_time_s > 0.0
    assert 0.0 <= runner.exposed_stage_s <= runner.stage_time_s + 1e-6
    assert all(r.stage_s > 0.0 for r in reports[:-1])
    assert reports[-1].stage_s == 0.0 and reports[-1].exposed_stage_s == 0.0


def test_runner_rejects_bad_meshes_and_windows(world):
    g, _, ws, dv, cfg = world
    flat = make_mesh((P_,), ("data",), device=CPU)
    with pytest.raises(ValueError, match="describes 6 workers"):
        DeviceRapidGNNRunner(ws, dv, cfg, AdamW(), flat, B, g.labels,
                             topology=Topology.hierarchical(2, 3))
    with pytest.raises(ValueError, match="'dcn', 'data'"):
        DeviceRapidGNNRunner(ws, dv, cfg, AdamW(), flat, B, g.labels,
                             topology=Topology.hierarchical(2, 2))
    with pytest.raises(ValueError, match="2-worker mesh"):
        DeviceRapidGNNRunner(ws, dv, cfg, AdamW(),
                             make_mesh((2,), ("data",), device=CPU), B,
                             g.labels)
    with pytest.raises(ValueError, match="bad epoch window"):
        _runner(world).run(start_epoch=EPOCHS)


# ---------------------------------------------------------------------------
# run-state checkpoints
# ---------------------------------------------------------------------------

def _like(runner):
    params = init_params(runner.cfg, torch.Generator().manual_seed(1), CPU)
    return {"params": params, "opt": runner.opt.init(params)}


def test_checkpoint_resume_stitched_bit_equal(world, clean, p0, tmp_path):
    full_runner, full = clean
    head_runner = _runner(world, checkpoint_dir=str(tmp_path))
    head = head_runner.run(params=p0, stop_epoch=1)
    assert len(head) == 1 and latest_step(str(tmp_path)) == 1
    tail_runner = _runner(world)
    state, step = load_run_state(str(tmp_path), _like(tail_runner))
    assert step == 1
    # the AdamW state round-trips bit for bit, its step count too
    assert _bits(state) == _bits({"params": head_runner.params,
                                  "opt": head_runner.opt_state})
    assert int(state["opt"].step) == head_runner.num_steps
    tail = tail_runner.run(params=state["params"], opt_state=state["opt"],
                           start_epoch=step)
    assert [r.epoch for r in tail] == [1, 2]
    np.testing.assert_array_equal(_curve(head + tail), _curve(full))
    np.testing.assert_array_equal(np.stack([r.miss_lanes for r in head + tail]),
                                  np.stack([r.miss_lanes for r in full]))
    assert _bits(tail_runner.params) == _bits(full_runner.params)
    assert _bits(tail_runner.opt_state) == _bits(full_runner.opt_state)


def test_run_state_crosses_packages(tmp_path):
    """A run state saved by the JAX package loads in the port and the
    port's loads in JAX, leaf for leaf (moments and step count too)."""
    jcfg = JConfig(kind="sage", in_dim=7, hidden_dim=5, num_classes=3,
                   num_layers=2)
    jp = j_init(jcfg, jax.random.key(3))
    jopt = JAdamW(lr=1e-2)
    grads = jax.tree.map(lambda a: a * 0.5 + 0.25, jp)
    jp2, jstate = jopt.update(grads, jopt.init(jp), jp)
    jtree = {"params": jp2, "opt": jstate}
    j_save_run_state(str(tmp_path / "jax"), jtree, step=5)
    tparams = params_from_numpy(jp, CPU)
    like = {"params": tparams, "opt": AdamW().init(tparams)}
    got, step = load_run_state(str(tmp_path / "jax"), like)
    assert step == 5 and int(got["opt"].step) == 1
    want = {k: np.asarray(v) for k, v in j_flatten(jtree)[0].items()}
    assert sorted(t_flatten(got)) == sorted(want)
    for k, v in t_flatten(got).items():
        assert isinstance(v, torch.Tensor)
        assert v.numpy().dtype == want[k].dtype, k
        assert v.numpy().tobytes() == want[k].tobytes(), k
    save_run_state(str(tmp_path / "port"), got, step=6)
    back, jstep = j_load_run_state(str(tmp_path / "port"), jtree)
    assert jstep == 6 == j_latest_step(str(tmp_path / "port"))
    for k, v in j_flatten(back)[0].items():
        assert np.asarray(v).tobytes() == want[k].tobytes(), k


def test_latest_step_empty_and_torn(tmp_path, world):
    like = _like(_runner(world))
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(CheckpointCorruptError, match="no LATEST"):
        load_run_state(str(tmp_path / "absent"), like)
    save_run_state(str(tmp_path), like, step=2)
    assert latest_step(str(tmp_path)) == 2
    (tmp_path / "LATEST").write_text("")            # torn pointer
    with pytest.raises(CheckpointCorruptError, match="torn LATEST"):
        latest_step(str(tmp_path))
    (tmp_path / "LATEST").write_text("7\n")         # names no checkpoint
    with pytest.raises(CheckpointCorruptError):
        load_run_state(str(tmp_path), like)


# ---------------------------------------------------------------------------
# fault profiles, each against the clean curve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["cache-loss", "stage-flaky",
                                     "stage-deadline", "run-crash"])
def test_fault_profile_keeps_the_curve(world, clean, p0, profile, tmp_path):
    _, base = clean
    kw = {"stage_deadline_s": 0.05} if profile == "stage-deadline" else {}
    if profile == "run-crash":
        kw = {"checkpoint_dir": str(tmp_path), "checkpoint_every": 1}
    runner = _runner(world, **kw)
    plan = plan_from_profile(profile, seed=3)
    if profile == "stage-deadline":
        # the port dispatches epoch 0 on the thread that submitted epoch
        # 1's stage, so the profile's hang is lengthened past any epoch
        # time under load: the stage must still hang at the deadline
        plan = FaultPlan(plan.seed, [dataclasses.replace(r, delay_s=3.0)
                                     for r in plan.rules], name=profile)
    with active_plan(plan):
        if profile == "run-crash":
            with pytest.raises(InjectedCrash):
                runner.run(params=p0)
        else:
            reports = runner.run(params=p0)
    assert plan.total_fires() >= 1
    if profile == "run-crash":
        # dies after the epoch-2 commit; the resume from LATEST is exact
        assert latest_step(str(tmp_path)) == 2
        fresh = _runner(world)
        state, step = load_run_state(str(tmp_path), _like(fresh))
        tail = fresh.run(params=state["params"], opt_state=state["opt"],
                         start_epoch=step)
        np.testing.assert_array_equal(_curve(tail), _curve(base[step:]))
        return
    np.testing.assert_array_equal(_curve(reports), _curve(base))
    if profile == "cache-loss":
        assert plan.fires("stage_cache", "drop") == 1
        assert runner.degraded_epochs == 1
        assert reports[1].degraded == 1
        assert reports[1].degrade_reason == "cache_lost"
        assert sum(r.degraded for r in reports) == 1
        assert 1 <= runner.trace_count <= 2
        assert reports[1].total_miss_lanes > base[1].total_miss_lanes
        for e in (0, 2):
            np.testing.assert_array_equal(reports[e].miss_lanes,
                                          base[e].miss_lanes)
        return
    assert runner.trace_count == 1
    assert sum(r.degraded for r in reports) == 0
    assert runner.stage_retries > 0
    if profile == "stage-deadline":
        assert plan.fires("stage", "hang") >= 1
        assert runner.deadline_overruns > 0
        assert runner.recovery_wall_s > 0.0


def test_stage_dead_raises_staging_error(world):
    runner = _runner(world)
    with active_plan(plan_from_profile("stage-dead", seed=3)):
        with pytest.raises(StagingError) as info:
            runner.run()
    assert info.value.__cause__ is not None


def test_checkpoint_crash_keeps_the_previous_latest(world, tmp_path):
    """A crash between the arrays and the manifest commit of step 2:
    LATEST stays on step 1, which restores intact."""
    runner = _runner(world, checkpoint_dir=str(tmp_path))
    with active_plan(plan_from_profile("ckpt-crash", seed=5)):
        with pytest.raises(InjectedCrash):
            runner.run()
    assert latest_step(str(tmp_path)) == 1
    state, step = load_run_state(str(tmp_path), _like(runner))
    assert step == 1 and int(state["opt"].step) == runner.num_steps


# ---------------------------------------------------------------------------
# topology and two-tier plans against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,dph", [(1, 4), (2, 2), (4, 1), (2, 3)])
def test_topology_matches_jax(hosts, dph):
    t, j = Topology.hierarchical(hosts, dph), JTopology.hierarchical(hosts,
                                                                     dph)
    for f in ("hosts", "devices_per_host", "num_workers", "is_hierarchical",
              "worker_axes"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.describe() == j.describe()
    w = np.arange(t.num_workers)
    for f in ("host_of", "local_of"):
        np.testing.assert_array_equal(getattr(t, f)(w), getattr(j, f)(w))
    np.testing.assert_array_equal(t.same_host(w[:, None], w[None]),
                                  j.same_host(w[:, None], w[None]))
    np.testing.assert_array_equal(t.owner_bias(0, 3.0), j.owner_bias(0, 3.0))
    assert Topology.parse(t.describe(), t.num_workers) == t
    mesh = t.make_mesh(CPU)
    assert mesh.num_workers == t.num_workers and mesh.device == CPU
    assert mesh.axis_names == (("dcn", "data") if hosts > 1 else ("data",))


def test_topology_errors_match_jax():
    for cls in (Topology, JTopology):
        for bad in ("2x3", "bad", "2x"):
            with pytest.raises(ValueError):
                cls.parse(bad, 4)
        with pytest.raises(ValueError):
            cls(ici_mesh_shape=(2,), dcn_mesh_shape=(2,),
                mesh_axis_names=("x",))
        with pytest.raises(ValueError):
            cls(ici_mesh_shape=(0,), dcn_mesh_shape=(2,),
                mesh_axis_names=("data",))
        with pytest.raises(ValueError):
            cls.flat(4).owner_bias(0, 0.0)


def _plan_case(seed: int, dups: bool = False):
    rng = np.random.default_rng(seed)
    n, groups = 400, 5
    ids = rng.integers(-1, 4 * 16, size=n)
    pos = rng.permutation(n)
    group = rng.integers(0, groups, size=n)
    requester = group % 4
    if dups:
        ids[10:20], pos[10:20], group[10:20] = ids[:10], pos[:10], group[:10]
        requester = group % 4
    owner = np.maximum(ids, 0) // 16
    return ids, pos, group, owner, requester, groups


@pytest.mark.parametrize("seed,dups", [(0, False), (1, True)])
def test_pack_pull_lanes_two_tier_matches_jax(seed, dups):
    ids, pos, group, owner, req, groups = _plan_case(seed, dups)
    t, j = Topology.hierarchical(2, 2), JTopology.hierarchical(2, 2)
    n = ids.size
    got = pack_pull_lanes_two_tier(ids, pos, group, owner, req, groups, t,
                                   n, n)
    want = j_pack_two_tier(ids, pos, group, owner, req, groups, j, n, n)
    for tier_t, tier_j in zip(got, want):
        for x, y in zip(tier_t, tier_j):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    # each lane rides exactly one tier: the tiers' counts add up to the
    # flat plan's per (group, owner)
    flat_counts = pack_pull_lanes(ids, pos, group, owner, groups, 4, n)[3]
    intra, inter = got[0][3], got[1][3]
    both = inter.copy()
    for g in range(groups):
        h = (g % 4) // 2
        both[g, 2 * h:2 * h + 2] += intra[g]
    np.testing.assert_array_equal(both, flat_counts)


def test_collate_two_tier_matches_jax(world):
    """Epoch 0 collated two-tier (2x2) by both packages, bit for bit,
    with equal split lane bounds; the tier masks add up to the flat
    lanes per worker."""
    g, _, ws, dv, _ = world
    jg = j_load("tiny")
    jpg = j_part(jg, P_, "greedy")
    jsmp = JSampler(jg, fanouts=list(FANOUTS), batch_size=B)
    jes = [j_build_schedule(jsmp, jpg, worker=w, s0=S0, num_epochs=1,
                            n_hot=N_HOT).epoch(0) for w in range(P_)]
    jdv = JDeviceView.build(jpg)
    es = [w.epoch(0) for w in ws]
    topo, jtopo = Topology.hierarchical(2, 2), JTopology.hierarchical(2, 2)
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    jcaches = [jdv.remap_cache(e.cache_ids) for e in jes]
    k_i, k_x = epoch_k_max_split(es, caches, dv, topo)
    assert (k_i, k_x) == j_k_split(jes, jcaches, jdv, jtopo)
    m_max = max(e.m_max for e in es)
    runner = _runner(world)
    S = max(e.num_batches for e in es)
    got = collate_device_epoch(es, caches, dv, g.labels, B, m_max,
                               runner.edge_max, k_i, S, topology=topo,
                               k_max_inter=k_x)
    want = j_collate(jes, jcaches, jdv, jg.labels, B, m_max, runner.edge_max,
                     k_i, S, topology=jtopo, k_max_inter=k_x)
    assert sorted(got) == sorted(want)
    for k in got:
        xs, ys = (got[k], want[k]) if isinstance(got[k], list) else \
            ([got[k]], [want[k]])
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
    flat = collate_device_epoch(es, caches, dv, g.labels, B, m_max,
                                runner.edge_max,
                                epoch_k_max(es, caches, dv), S)
    np.testing.assert_array_equal(
        got["intra_mask"].sum(axis=(0, 2, 3))
        + got["inter_mask"].sum(axis=(0, 2, 3)),
        flat["send_mask"].sum(axis=(0, 2, 3)))


# ---------------------------------------------------------------------------
# the two-tier exchange: one process and 4 gloo ranks
# ---------------------------------------------------------------------------

def _exchange_case():
    """A 2x2 mesh's table (with -0.0 entries) and both plans for the
    same requests: flat (P, P, k) and two-tier."""
    n_per, d, m_max = 16, 8, 14
    rng = np.random.default_rng(7)
    table = rng.normal(size=(P_, n_per, d)).astype(np.float32)
    table[1, 3, :3] = -0.0
    table[2, 0, :] = -0.0
    ids, pos, req = [], [], []
    for r in range(P_):
        ids.append(rng.choice(P_ * n_per, size=m_max - 3, replace=False))
        pos.append(rng.permutation(m_max)[:m_max - 3])
        req.append(np.full(m_max - 3, r))
    ids, pos, req = (np.concatenate(a) for a in (ids, pos, req))
    ids[0] = 2 * n_per                        # the -0.0 row
    owner = ids // n_per
    flat = pack_pull_lanes(ids, pos, req, owner, P_, P_, m_max)[:3]
    topo = Topology.hierarchical(2, 2)
    intra, inter = pack_pull_lanes_two_tier(ids, pos, req, owner, req, P_,
                                            topo, m_max, m_max)
    two = {f"{t}_{k}": a for t, lanes in (("intra", intra),
                                           ("inter", inter))
           for k, a in zip(("ids", "pos", "mask"), lanes)}
    offsets = (np.arange(P_) * n_per).astype(np.int32)
    return table, flat, two, offsets, m_max


def test_pull_features_two_tier_bit_equal_flat():
    table, flat, two, offsets, m_max = _exchange_case()
    tt = torch.from_numpy(table)
    want = pull_features(make_mesh((P_,), ("data",), device=CPU), tt,
                         *(torch.from_numpy(a) for a in flat),
                         torch.from_numpy(offsets), m_max)
    mesh = make_mesh((2, 2), ("dcn", "data"), device=CPU)
    send = {k: torch.from_numpy(v) for k, v in two.items()}
    got = pull_features_two_tier(mesh, tt, send, torch.from_numpy(offsets),
                                 m_max)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert not np.signbit(got.numpy()[got.numpy() == 0]).any()
    out = torch.full_like(got, 5.0)
    pull_features_two_tier(mesh, tt, send, torch.from_numpy(offsets), m_max,
                           out=out)
    assert torch.equal(out, got)
    with pytest.raises(ValueError, match="two-tier lanes"):
        pull_features_two_tier(make_mesh((4,), ("data",), device=CPU), tt,
                               send, torch.from_numpy(offsets), m_max)


def test_pull_shard_two_tier_on_gloo_ranks(tmp_path):
    table, flat, two, offsets, m_max = _exchange_case()
    inp = tmp_path / "in.npz"
    np.savez(inp, table=table, offsets=offsets, m_max=np.int64(m_max),
             devices_per_host=np.int64(2), **two)
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable,
                        str(REPO / "tests" / "_torch_dist_gloo.py"),
                        str(inp), str(tmp_path)], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    want = pull_features(make_mesh((P_,), ("data",), device=CPU),
                         torch.from_numpy(table),
                         *(torch.from_numpy(a) for a in flat),
                         torch.from_numpy(offsets), m_max).numpy()
    for r in range(P_):
        assert np.load(tmp_path / f"rank{r}.npy").tobytes() == \
            want[r].tobytes()
