"""The port's ``("data", "model")`` mesh against the JAX package, on the
CPU: the sequence-sharded decode attention, the expert-parallel MoE and
the model paths that carry a mesh.

The reference's mesh results come from one subprocess on 4 emulated
devices (``tests/_torch_shard_ref.py``), each in the mesh context it
runs in under jax 0.9.0. Float32 throughout, within ``rtol=1e-4,
atol=1e-5`` (the decode attention, the MoE and its gradient: sums of a
few terms taken in another order) and ``rtol=1e-4, atol=1e-4`` for a
model's logits (the reference's cross-program tolerance for whole
models), with the capacity factor at 1.0 so tokens are dropped and the
grouping of the tokens by data group shows. ``lm_loss`` over a mesh does
not run in the reference (its shard_map asks for ``jax.set_mesh``, under
which the layer scan's carry changes type), so the port's is held at
``capacity_factor=4.0``, where nothing is dropped, against the
reference's without a mesh.

The process-group bodies (``sharded_decode_shard``, ``moe_shard``) run
on 2 and 4 gloo ranks (``tests/_torch_shard_gloo.py``) and are held
against the in-process forms: bit for bit at tp = 2, where every
cross-rank sum has two terms; within ``rtol=1e-6, atol=1e-6`` at tp = 4,
where gloo adds the four in an order of its own.
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
import jax.numpy as jnp

import _torch_shard_ref as R
from repro.configs import get_reduced as j_get_reduced
from repro.models.transformer import init_params as j_init
from repro.models.transformer.model import lm_loss as j_lm_loss
from repro_torch.configs import get_reduced
from repro_torch.dist import DeviceRapidGNNRunner, dp_axes, make_mesh
from repro_torch.dist.feature_a2a import pull_features
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.models.transformer import (forward, init_decode_state,
                                            init_params, lm_loss,
                                            make_train_step,
                                            moe_apply, params_from_numpy,
                                            serve_step)
from repro_torch.models.transformer.attention import decode_attention
from repro_torch.models.transformer.common import ArchConfig
from repro_torch.serve import sharded_decode_attention
from repro_torch.train import AdamW
from repro_torch.train.optim import tree_leaves, tree_map
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


def _mesh(shape):
    return make_mesh(shape, ("data", "model"), device=CPU)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's mesh results (4 emulated devices) from one
    subprocess."""
    out = tmp_path_factory.mktemp("shard_ref") / "ref.npz"
    env = capped_env("--xla_force_host_platform_device_count=4",
                     PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "_torch_shard_ref.py"), str(out)],
                       env=env, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    return dict(np.load(out))


def _init_params(cfg):
    return init_params(cfg, torch.Generator().manual_seed(0))


def _ref_params(ref, prefix, jcfg, seed):
    """The reference's parameter tree of a case, rebuilt from its leaves
    in the ``.npz``, as the port's tensors."""
    treedef = jax.tree.structure(jax.eval_shape(
        lambda: j_init(jcfg, jax.random.key(seed))))
    leaves = [ref[f"{prefix}_p{i}"] for i in range(treedef.num_leaves)]
    return params_from_numpy(jax.tree.unflatten(treedef, leaves))


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axes,want", [
    ((4,), ("data",), {"data": 4}),
    ((2, 2), ("dcn", "data"), {"dcn": 2, "data": 2}),
    ((2, 2), ("data", "model"), {"data": 2, "model": 2}),
    ((1, 4), ("data", "model"), {"data": 1, "model": 4}),
    ((3, 1), ("data", "model"), {"data": 3}),
])
def test_mesh_shape_and_dp_axes(shape, axes, want):
    mesh = make_mesh(shape, axes, device=CPU)
    assert mesh.shape == want and tuple(mesh.axis_names) == tuple(want)
    assert mesh.shape.get("model", 1) == want.get("model", 1)
    assert dp_axes(mesh) == tuple(a for a in ("dcn", "data") if a in want)
    assert mesh.num_workers == want.get("dcn", 1) * want["data"]


@pytest.mark.parametrize("shape,axes", [
    ((2, 2), ("model", "data")), ((4,), ("model",)),
    ((2, 2, 1), ("dcn", "data", "model")), ((2,), ("data", "model"))])
def test_other_layouts_raise(shape, axes):
    with pytest.raises(NotImplementedError, match="over"):
        make_mesh(shape, axes, device=CPU)


def test_gnn_users_reject_a_model_mesh():
    mesh = _mesh((2, 2))
    table = torch.zeros((2, 4, 3))
    ids = torch.zeros((2, 2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="model shards"):
        pull_features(mesh, table, ids, ids, ids.bool(),
                      torch.tensor([0, 4], dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="model shards"):
        DeviceRapidGNNRunner([None, None], None, None, None, mesh, 16, None)


# ---------------------------------------------------------------------------
# sharded_decode_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(R.DECODE_CASES))
def test_sharded_decode_attention_matches_reference(ref, name, monkeypatch):
    shape, B, G, cap, lens = R.DECODE_CASES[name]
    q, k, v, ln = (_t(ref[f"dec_{name}_{x}"])
                   for x in ("q", "k", "v", "len"))
    calls = []
    plain = t_fd_ops.flash_decode_batched_ref
    monkeypatch.setattr(t_fd_ops, "flash_decode_batched_ref",
                        lambda *a, **kw: calls.append(a[0].shape) or
                        plain(*a, **kw))
    got = sharded_decode_attention(_mesh(shape), q, k, v, ln,
                                   attn_softcap=cap)
    tp = shape[1]
    # one call of the partials over the folded batch, B * tp rows
    assert calls == [(B * tp, G * k.shape[2], k.shape[3])]
    assert got.shape == q.shape and got.dtype == q.dtype
    _close(got, ref[f"dec_{name}_out"])
    _close(got, decode_attention(q, k, v, ln, attn_softcap=cap).numpy())
    # a shard of no valid slot adds exactly nothing; a length of 0 gives 0
    assert bool((got[ln == 0] == 0).all())


def test_sharded_decode_attention_raises_for_a_cache_tp_does_not_split():
    q = torch.zeros((1, 1, 2, 8))
    k = torch.zeros((1, 30, 2, 8))
    with pytest.raises(ValueError, match="does not split over 4"):
        sharded_decode_attention(_mesh((1, 4)), q, k, k,
                                 torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# moe_apply over the mesh, both variants, and its gradient
# ---------------------------------------------------------------------------

def _moe_case(ref, name):
    shape, E, res, cf, _ = R.MOE_CASES[name]
    cfg = ArchConfig(name="moe", moe=True, num_experts=E, dtype="float32",
                     capacity_factor=cf, moe_resident_experts=res,
                     **R.MOE_DIMS)
    params = {k: _t(ref[f"moe_{name}_{k}"]) for k in ("router", "w1", "w2",
                                                      "w3")}
    return shape, cfg, params, _t(ref[f"moe_{name}_x"])


@pytest.mark.parametrize("name", sorted(R.MOE_CASES))
def test_moe_apply_mesh_and_grads_match_reference(ref, name):
    shape, cfg, params, x = _moe_case(ref, name)
    p = tree_map(lambda t: t.clone().requires_grad_(True), params)
    xg = x.clone().requires_grad_(True)
    out = moe_apply(p, xg, cfg, mesh=_mesh(shape))
    _close(out, ref[f"moe_{name}_out"])
    gp = torch.autograd.grad((out * _t(ref[f"moe_{name}_ct"])).sum(),
                             [p["router"], p["w1"], p["w2"], p["w3"], xg])
    for k, g in zip(("router", "w1", "w2", "w3"), gp):
        _close(g, ref[f"moe_{name}_g{k}"])
    _close(gp[-1], ref[f"moe_{name}_gx"])


def test_moe_expert_parallel_routes_each_data_group_alone(ref):
    """With drops (capacity factor 1.0), the (2, 2) mesh's result is each
    data group's tokens routed alone -- not the whole batch's."""
    shape, cfg, params, x = _moe_case(ref, "m22_ep_cf1_2x8")
    got = moe_apply(params, x, cfg, mesh=_mesh(shape))
    groups = torch.cat([moe_apply(params, xg[None], cfg)[0]
                        for xg in x.reshape(2, -1, x.shape[-1])])
    _close(got, groups.reshape(x.shape).numpy())
    assert float((got - moe_apply(params, x, cfg)).abs().max()) > 1e-2
    # 5 tokens do not split over 2 groups: all of them are one group
    shape, cfg, params, x = _moe_case(ref, "m22_ep_cf1_1x5")
    torch.testing.assert_close(moe_apply(params, x, cfg, mesh=_mesh(shape)),
                               moe_apply(params, x, cfg), **TOL)


def test_moe_apply_raises_when_tp_does_not_split_the_experts(ref):
    _, cfg, params, x = _moe_case(ref, "m22_ep_cf1_2x8")
    with pytest.raises(ValueError, match="4 experts do not split over 3"):
        moe_apply(params, x, cfg, mesh=_mesh((1, 3)))


def test_moe_resident_raises_when_dp_does_not_split_the_ff(ref):
    """The weight-stationary variant cuts the FF width over the data
    ranks: 16 columns do not split over 3 (6 tokens do)."""
    _, cfg, params, x = _moe_case(ref, "m22_res_cf1_2x8")
    with pytest.raises(ValueError, match="FF width of 16 does not split "
                                         "over 3"):
        moe_apply(params, x[:, :3], cfg, mesh=_mesh((3, 2)))


# ---------------------------------------------------------------------------
# the model paths: forward, serve_step, lm_loss, make_train_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(R.FORWARD_CASES))
def test_forward_mesh_matches_reference(ref, name):
    arch, kw = R.FORWARD_CASES[name]
    cfg = dataclasses.replace(get_reduced(arch), **kw)
    tp = _ref_params(ref, f"fwd_{name}",
                     dataclasses.replace(j_get_reduced(arch), **kw), 5)
    toks = _t(ref[f"fwd_{name}_tokens"])
    with torch.no_grad():
        got = forward(cfg, tp, toks, mesh=_mesh((2, 2)))
    _close(got, ref[f"fwd_{name}_out"], **MODEL_TOL)


def test_seq_shard_attn_is_a_layout_hint():
    """``seq_shard_attn`` changes no value: the port's forward over a
    model mesh is the same bits with and without it."""
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"),
                              capacity_factor=1.0)
    p = _init_params(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(3))
    mesh = _mesh((2, 2))
    with torch.no_grad():
        a = forward(cfg, p, toks, mesh=mesh)
        b = forward(dataclasses.replace(cfg, seq_shard_attn=True), p, toks,
                    mesh=mesh)
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(R.SERVE_CASES))
def test_serve_step_mesh_loop_matches_reference(ref, name):
    arch, kw, shape = R.SERVE_CASES[name]
    cfg = dataclasses.replace(get_reduced(arch), **kw)
    jcfg = dataclasses.replace(j_get_reduced(arch), unroll_layers=True, **kw)
    tp = _ref_params(ref, f"srv_{name}", jcfg, 8)
    toks = _t(ref[f"srv_{name}_tokens"])
    B, mesh = R.SERVE_B, _mesh(shape)
    states = init_decode_state(cfg, B, R.SERVE_STEPS, device=CPU)
    steps = []
    with torch.no_grad():
        for t in range(R.SERVE_STEPS):
            lg, states = serve_step(cfg, tp, states, toks[:, t:t + 1],
                                    torch.full((B,), t, dtype=torch.int32),
                                    mesh=mesh)
            steps.append(lg[:, 0])
    _close(torch.stack(steps, 1), ref[f"srv_{name}_logits"], **MODEL_TOL)
    _close(states["scan"][0]["k"], ref[f"srv_{name}_k0"], **MODEL_TOL)


def _lm_batch(cfg):
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "loss_mask": (rng.random((2, 16)) < 0.8).astype(np.float32)}


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_lm_loss_mesh_and_grads_match_reference_without_drops(arch):
    cfg, jcfg = get_reduced(arch), j_get_reduced(arch)
    assert cfg.capacity_factor == 4.0
    jp = R.filled_params(jcfg, 12)
    nb = _lm_batch(cfg)
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    p = tree_map(lambda t: t.requires_grad_(True), params_from_numpy(jp))
    loss, _ = lm_loss(cfg, p, {k: _t(v) for k, v in nb.items()},
                      mesh=_mesh((2, 2)))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    _close(loss, jloss)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        _close(g, w)


def test_train_step_over_a_mesh_equals_without_drops():
    cfg = get_reduced("qwen3-moe-30b-a3b")
    batch = {k: _t(v) for k, v in _lm_batch(cfg).items()}
    runs = []
    for mesh in (None, _mesh((2, 2))):
        params = _init_params(cfg)
        opt = AdamW(lr=3e-4)
        step = make_train_step(cfg, opt, mesh=mesh)
        params, _, aux = step(params, opt.init(params), batch)
        runs.append((aux["loss"], tree_leaves(params)))
    _close(runs[1][0], runs[0][0].numpy())
    # AdamW's first update is lr * g / (|g| + eps), about lr times the
    # sign of g: a gradient within float noise of 0 may flip it, so the
    # parameters agree to 2 lr (the gradients themselves are held above)
    for a, b in zip(runs[1][1], runs[0][1]):
        _close(a, b.numpy(), rtol=0, atol=2 * 3e-4 + 1e-6)


# ---------------------------------------------------------------------------
# the process-group bodies on gloo ranks
# ---------------------------------------------------------------------------

def _gloo_inputs(ref):
    """The decode case of (2, 2) with its empty shards, and the MoE case
    with drops."""
    name = "m22_g4_cap"
    _, cfg, params, x = _moe_case(ref, "m22_ep_cf1_2x8")
    return dict(
        q=ref[f"dec_{name}_q"], k=ref[f"dec_{name}_k"],
        v=ref[f"dec_{name}_v"], length=ref[f"dec_{name}_len"],
        softcap=R.DECODE_CASES[name][3],
        **{k: v.numpy() for k, v in params.items()},
        x=x.reshape(-1, x.shape[-1]).numpy(), num_experts=cfg.num_experts,
        top_k=cfg.top_k, d_model=cfg.d_model, moe_d_ff=cfg.moe_d_ff,
        capacity_factor=cfg.capacity_factor), cfg


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (1, 4)])
def test_process_group_bodies_on_gloo_equal_the_in_process_forms(
        ref, tmp_path, dp, tp):
    inp, cfg = _gloo_inputs(ref)
    np.savez(tmp_path / "in.npz", world=dp * tp, tp=tp, **inp)
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run([sys.executable, str(REPO / "tests" /
                                            "_torch_shard_gloo.py"),
                        str(tmp_path / "in.npz"), str(tmp_path)], env=env,
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stdout + p.stderr
    mesh = _mesh((dp, tp))
    dec = sharded_decode_attention(mesh, *map(_t, (
        inp["q"], inp["k"], inp["v"], inp["length"])),
        attn_softcap=inp["softcap"]).numpy()
    x = _t(inp["x"])
    moe = moe_apply({k: _t(inp[k]) for k in ("router", "w1", "w2", "w3")},
                    x[None], cfg, mesh=mesh)[0].numpy()
    B, T = dec.shape[0], moe.shape[0]
    for rank in range(dp * tp):
        g = rank // tp
        got = np.load(tmp_path / f"rank{rank}.npz")
        want_dec = dec[g * B // dp:(g + 1) * B // dp]
        want_moe = moe[g * T // dp:(g + 1) * T // dp]
        if tp == 2:
            assert got["decode"].tobytes() == want_dec.tobytes()
            assert got["moe"].tobytes() == want_moe.tobytes()
        else:
            np.testing.assert_allclose(got["decode"], want_dec, rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(got["moe"], want_moe, rtol=1e-6,
                                       atol=1e-6)
