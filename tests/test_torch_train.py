"""The port's training path against the JAX package, on the CPU.

Within the reference's cross-program tolerance (``rtol=1e-4,
atol=1e-5``): the ``gather_agg`` backward (plain version, through the
autograd Function) against ``jax.grad`` of the JAX kernel in interpret
mode; one train step (loss, accuracy, every gradient leaf, parameters
and moments after ``AdamW.update``) for GraphSAGE and GCN on both of the
port's aggregation backends; ``AdamW`` and ``SGD`` over 5 steps; and the
host-sim ``RapidGNNRunner`` / ``BaselineRunner`` loss curves over 2
epochs, whose counters must be exactly equal. Also the launcher and
checkpoints that load in either package.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_cases import BWD_CASES, bwd_case, to_t
from repro.core import (BaselineRunner as JBaseline,
                        NetworkModel as JNet,
                        RapidGNNRunner as JRapid,
                        ShardedFeatureStore as JStore,
                        build_schedule as j_build_schedule)
from repro.graph import KHopSampler as JSampler
from repro.graph import load_dataset as j_load, partition_graph as j_part
from repro.kernels.gather_agg.ops import gather_agg as j_gather_agg
from repro.models.gnn import GNNConfig as JConfig
from repro.models.gnn import (batch_to_device as j_batch_to_device,
                              init_params as j_init, loss_fn as j_loss_fn,
                              make_train_step as j_make_step)
from repro.train import AdamW as JAdamW, SGD as JSGD
from repro.train import (cosine_schedule as j_cosine,
                         global_norm as j_global_norm,
                         load_checkpoint as j_load_ckpt,
                         save_checkpoint as j_save_ckpt)
from repro_torch.core import (BaselineRunner as TBaseline,
                              NetworkModel as TNet,
                              RapidGNNRunner as TRapid,
                              ShardedFeatureStore as TStore,
                              build_schedule as t_build_schedule)
from repro_torch.graph import KHopSampler as TSampler
from repro_torch.graph import load_dataset as t_load, partition_graph as t_part
from repro_torch.kernels.gather_agg import ops as t_gather_ops
from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
from repro_torch.models.gnn import GNNConfig as TConfig
from repro_torch.models.gnn import (batch_to_device as t_batch_to_device,
                                    loss_and_grads as t_loss_and_grads,
                                    make_train_step as t_make_step,
                                    params_from_numpy)
from repro_torch.train import AdamW as TAdamW, SGD as TSGD
from repro_torch.train import (checkpoint_step as t_ckpt_step,
                               cosine_schedule as t_cosine,
                               global_norm as t_global_norm,
                               load_checkpoint as t_load_ckpt,
                               opt_state_from_numpy,
                               save_checkpoint as t_save_ckpt)
from repro_torch.train.optim import tree_leaves
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
FANOUTS = (5, 5)
HIDDEN = 16


def _np(tree):
    """JAX or torch tree -> list of numpy leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _np(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [np.asarray(tree)]


def assert_trees_close(jt, tt):
    a, b = _np(jt), _np(tt)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(y, x, **TOL)


# ---------------------------------------------------------------------------
# the gather_agg backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(BWD_CASES))
def test_gather_agg_backward_matches_jax_vjp(name):
    g, src, mask, m, nd, fo = bwd_case(name)
    rng = np.random.default_rng(len(name))
    h = rng.normal(size=(m, g.shape[1])).astype(np.float32)

    def j_obj(hh):
        out = j_gather_agg(hh, jnp.asarray(src), jnp.asarray(mask), nd=nd,
                           fanout=fo, use_kernel=True, interpret=True)
        return jnp.sum(out * jnp.asarray(g))
    want = np.asarray(jax.grad(j_obj)(jnp.asarray(h)))

    th = torch.from_numpy(h).requires_grad_(True)
    ts, tm = to_t(src, mask)
    before = t_gather_ops.BWD_LAUNCHES.value
    out = t_gather_ops.gather_agg(th, ts, tm, nd=nd, fanout=fo)
    (torch.from_numpy(g) * out).sum().backward()
    assert t_gather_ops.BWD_LAUNCHES.value == before     # CPU: plain
    np.testing.assert_allclose(th.grad.numpy(), want, **TOL)
    direct = t_gather_ops.gather_agg_bwd(torch.from_numpy(g), ts, tm, m=m,
                                         nd=nd, fanout=fo)
    np.testing.assert_array_equal(direct.numpy(), th.grad.numpy())
    np.testing.assert_array_equal(
        direct.numpy(),
        gather_agg_bwd_ref(torch.from_numpy(g), ts, tm, m, nd, fo).numpy())
    unread = np.setdiff1d(np.arange(m), src[mask])
    assert unread.size and not direct.numpy()[unread].any()


def test_gather_agg_backward_skipped_without_grad_and_edges_get_none():
    g, src, mask, m, nd, fo = bwd_case("small")
    h = torch.zeros((m, g.shape[1]))
    w = torch.ones((m, g.shape[1]), requires_grad=True)
    ts, tm = to_t(src, mask)
    # h needs no gradient (layer 0's input features): only w gets one
    out = t_gather_ops.gather_agg(h, ts, tm, nd=nd, fanout=fo)
    assert not out.requires_grad
    out2 = t_gather_ops.gather_agg(h * w, ts, tm, nd=nd, fanout=fo)
    out2.sum().backward()
    assert w.grad is not None and ts.grad is None and tm.grad is None
    with pytest.raises(ValueError):
        t_gather_ops.gather_agg_bwd(torch.zeros((nd + 1, 3)), ts, tm, m=m,
                                    nd=nd, fanout=fo)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def worlds():
    gj, gt = j_load("tiny", seed=0), t_load("tiny", seed=0)
    return ((gj, j_part(gj, 4, "greedy")), (gt, t_part(gt, 4, "greedy")))


@pytest.fixture(scope="module")
def one_batch(worlds):
    """A collated batch of the port's schedule (bit-equal to the JAX
    one, ``test_torch_schedule``) with its feature rows."""
    _, (gt, pt) = worlds
    ws = t_build_schedule(TSampler(gt, fanouts=list(FANOUTS), batch_size=32),
                          pt, worker=0, s0=3, num_epochs=1, n_hot=64)
    m_max, edge_max = ws.pad_bounds()
    from repro_torch.core import collate
    cb = collate(ws.epoch(0).batches[1], gt.labels, 32, m_max, edge_max)
    feats = np.zeros((m_max, gt.feat_dim), np.float32)
    feats[cb.input_mask] = gt.features[cb.input_nodes[cb.input_mask]]
    return cb, feats


@pytest.mark.parametrize("kind", ["sage", "gcn"])
@pytest.mark.parametrize("backend", ["kernel", "segment"])
def test_train_step_matches_jax(worlds, one_batch, kind, backend):
    (gj, _), _ = worlds
    cb, feats = one_batch
    jcfg = JConfig(kind=kind, in_dim=gj.feat_dim, hidden_dim=HIDDEN,
                   num_classes=gj.num_classes, num_layers=2)
    tcfg = TConfig(kind=kind, in_dim=gj.feat_dim, hidden_dim=HIDDEN,
                   num_classes=gj.num_classes, num_layers=2,
                   fanouts=FANOUTS, agg_backend=backend)
    jparams = j_init(jcfg, jax.random.key(1))
    jb = j_batch_to_device(cb, feats)
    tb = t_batch_to_device(cb, feats, CPU)

    # loss, accuracy and every gradient leaf
    (jl, ja), jg = jax.value_and_grad(
        lambda p: j_loss_fn(jcfg, p, jb["features"], jb["edge_src"],
                            jb["edge_dst"], jb["edge_mask"], jb["labels"],
                            jb["seed_mask"]), has_aux=True)(jparams)
    tl, ta, tg = t_loss_and_grads(tcfg, params_from_numpy(jparams, CPU), tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    np.testing.assert_allclose(float(ta), float(ja), **TOL)
    assert_trees_close(jg, tg)

    # two steps: the second starts from the JAX moments of the first
    jopt = JAdamW(lr=3e-3, weight_decay=0.01, max_grad_norm=1.0)
    topt = TAdamW(lr=3e-3, weight_decay=0.01, max_grad_norm=1.0)
    jstep, tstep = j_make_step(jcfg, jopt), t_make_step(tcfg, topt)
    jp1, js1, _ = jstep(jparams, jopt.init(jparams), jb)
    jp2, js2, jaux = jstep(jp1, js1, jb)
    tp2, ts2, taux = tstep(params_from_numpy(jp1, CPU),
                           opt_state_from_numpy(js1, CPU), tb)
    np.testing.assert_allclose(float(taux["loss"]), float(jaux["loss"]),
                               **TOL)
    assert int(ts2.step) == int(js2.step) == 2
    assert_trees_close(jp2, tp2)
    assert_trees_close(js2.mu, ts2.mu)
    assert_trees_close(js2.nu, ts2.nu)


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _opt_case():
    rng = np.random.default_rng(11)
    shapes = {"layers": [{"w": (6, 4), "b": (4,)}, {"w": (4, 3), "b": (3,)}]}
    params = {"layers": [{k: rng.normal(size=s).astype(np.float32)
                          for k, s in layer.items()}
                         for layer in shapes["layers"]]}
    grads = [{"layers": [{k: (3 * rng.normal(size=s)).astype(np.float32)
                          for k, s in layer.items()}
                         for layer in shapes["layers"]]} for _ in range(5)]
    return params, grads


def _to_torch(tree):
    return {"layers": [{k: torch.tensor(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


def _to_jax(tree):
    return {"layers": [{k: jnp.asarray(v) for k, v in layer.items()}
                       for layer in tree["layers"]]}


@pytest.mark.parametrize("which", ["adamw", "adamw_clip_decay", "sgd"])
def test_optimizers_match_jax_over_five_steps(which):
    params, grads = _opt_case()
    if which == "sgd":
        jopt, topt = JSGD(lr=0.05, momentum=0.8), TSGD(lr=0.05, momentum=0.8)
    elif which == "adamw":
        jopt, topt = JAdamW(lr=1e-2), TAdamW(lr=1e-2)
    else:
        kw = dict(lr=1e-2, weight_decay=0.05, max_grad_norm=0.5)
        jopt, topt = JAdamW(**kw), TAdamW(**kw)
    jp, tp = _to_jax(params), _to_torch(params)
    jst, tst = jopt.init(jp), topt.init(tp)
    j_sched, t_sched = j_cosine(0.9, 2, 5), t_cosine(0.9, 2, 5)
    for i, g in enumerate(grads):
        np.testing.assert_allclose(float(t_sched(i)), float(j_sched(i)),
                                   **TOL)
        jp, jst = jopt.update(_to_jax(g), jst, jp, lr_scale=j_sched(i))
        tp, tst = topt.update(_to_torch(g), tst, tp, lr_scale=t_sched(i))
        assert_trees_close(jp, tp)
    np.testing.assert_allclose(float(t_global_norm(tp)),
                               float(j_global_norm(jp)), **TOL)
    assert int(tst.step) == int(jst.step) == 5
    assert all(not t.requires_grad for t in tree_leaves(tp))


# ---------------------------------------------------------------------------
# host-sim runners, two epochs
# ---------------------------------------------------------------------------

def _run(pkg, worlds, runner, compiler="batched"):
    (gj, pj), (gt, pt) = worlds
    if pkg == "jax":
        g, pg, sampler_cls, build = gj, pj, JSampler, j_build_schedule
        store = JStore(pj, worker=0, net=JNet(enabled=False))
    else:
        g, pg, sampler_cls, build = gt, pt, TSampler, t_build_schedule
        store = TStore(pt, worker=0, net=TNet(enabled=False))
    kw = {} if pkg == "jax" else dict(compiler=compiler, device=CPU)
    ws = build(sampler_cls(g, fanouts=list(FANOUTS), batch_size=48), pg,
               worker=0, s0=5, num_epochs=2, n_hot=48, **kw)
    jcfg = JConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                   num_classes=g.num_classes, num_layers=2)
    jparams = j_init(jcfg, jax.random.key(2))
    hist = []
    if pkg == "jax":
        opt = JAdamW(lr=3e-3)
        step = j_make_step(jcfg, opt)
        state = [jparams, opt.init(jparams)]

        def train_fn(feats, cb):
            state[0], state[1], aux = step(state[0], state[1],
                                           j_batch_to_device(cb, feats))
            hist.append(float(aux["loss"]))
            return hist[-1]
    else:
        tcfg = TConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=HIDDEN,
                       num_classes=g.num_classes, num_layers=2,
                       fanouts=FANOUTS, agg_backend="kernel")
        opt = TAdamW(lr=3e-3)
        step = t_make_step(tcfg, opt)
        params = params_from_numpy(jparams, CPU)
        state = [params, opt.init(params)]

        def train_fn(feats, cb):
            state[0], state[1], aux = step(
                state[0], state[1], t_batch_to_device(cb, feats, CPU))
            hist.append(float(aux["loss"]))
            return hist[-1]
    if runner == "rapidgnn":
        cls = JRapid if pkg == "jax" else TRapid
        metrics = cls(ws, store, batch_size=48, Q=2,
                      train_fn=train_fn).run()
    else:
        cls = JBaseline if pkg == "jax" else TBaseline
        metrics = cls(ws, store, batch_size=48, train_fn=train_fn).run()
    return hist, metrics


COUNTERS = ("rpc_count", "sync_pull_calls", "remote_bytes",
            "vector_pull_bytes", "cache_hits", "cache_misses",
            "remote_requests")


@pytest.mark.parametrize("runner", ["rapidgnn", "baseline"])
def test_runner_loss_curve_and_counters_match_jax(worlds, runner):
    jh, jm = _run("jax", worlds, runner)
    th, tm = _run("torch", worlds, runner)
    assert len(jh) == len(th) > 2
    np.testing.assert_allclose(th, jh, **TOL)
    for k in COUNTERS:
        assert tm.totals()[k] == jm.totals()[k], k
    assert [e.cache_misses for e in tm.epochs] == \
        [e.cache_misses for e in jm.epochs]
    if runner == "rapidgnn":
        assert tm.totals()["cache_hits"] > 0
        # the schedule compiled through the device path is the same
        # schedule, so the run is the same run
        dh, dm = _run("torch", worlds, runner, compiler="device")
        assert dh == th
        for k in COUNTERS:
            assert dm.totals()[k] == tm.totals()[k], k


# ---------------------------------------------------------------------------
# launcher and checkpoints
# ---------------------------------------------------------------------------

def test_launcher_trains_on_cpu():
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--dataset", "tiny", "--epochs", "2", "--batch-size", "64"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "final loss" in p.stdout and "rpc_count" in p.stdout
    assert "hit_rate" in p.stdout
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--workload", "lm", "--steps", "12", "--seq", "32"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "== lm smollm-360m (reduced) on cpu == 12 steps" in p.stdout


def test_checkpoints_load_in_either_package(tmp_path):
    cfg = JConfig(kind="sage", in_dim=7, hidden_dim=5, num_classes=3,
                  num_layers=2)
    jparams = j_init(cfg, jax.random.key(4))
    tparams = params_from_numpy(j_init(cfg, jax.random.key(5)), CPU)
    t_save_ckpt(str(tmp_path / "port"), tparams, step=17)
    got = j_load_ckpt(str(tmp_path / "port"), jparams, expect_step=17)
    for a, b in zip(_np(got), _np(tparams)):
        np.testing.assert_array_equal(a, b)
    j_save_ckpt(str(tmp_path / "jax"), jparams, step=3)
    back = t_load_ckpt(str(tmp_path / "jax"), tparams, expect_step=3)
    assert t_ckpt_step(str(tmp_path / "jax")) == 3
    assert isinstance(back["layers"][0]["w_self"], torch.Tensor)
    for a, b in zip(_np(back), _np(jparams)):
        np.testing.assert_array_equal(a, b)
    from repro_torch.train import CheckpointCorruptError
    with pytest.raises(CheckpointCorruptError):
        t_load_ckpt(str(tmp_path / "jax"), tparams, expect_step=4)
    with pytest.raises(CheckpointCorruptError):
        t_load_ckpt(str(tmp_path / "jax"), {"layers": tparams["layers"][:1]})
