"""The port's LM training slice against the JAX package, on the CPU.

Within the reference's cross-program tolerance (``rtol=1e-4,
atol=1e-5``), from the JAX ``init_params`` output carried across with
``params_from_numpy`` and the same numpy tokens: ``lm_loss`` and every
gradient leaf against ``jax.value_and_grad(lm_loss)`` for the reduced
smollm-360m, gemma2-2b (window, softcaps, post-norms, embedding scale),
granite-3-2b, qwen1.5-32b (qkv bias), smollm-360m with per-head q/k
norm, qwen3-moe-30b-a3b and arctic-480b (MoE, arctic with its dense
residual), mamba2-1.3b (SSD) and recurrentgemma-9b (RG-LRU and local
attention), each with several attention chunks; 3 AdamW steps (losses,
moments, clipped update, weight decay) against the reference's jitted
step; the chunked attention's gradient with a window and with a softcap;
decode with qkv bias and q/k norm against the reference's
``serve_step``. Within the
port: two fresh runs bit-equal, the ``--workload lm`` launcher, and LM
checkpoints that load in either package.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.data.pipeline import synthetic_lm_batches as j_batches
from repro.models.transformer import (init_decode_state as j_init_state,
                                      init_params as j_init,
                                      serve_step as j_serve_step)
from repro.models.transformer.attention import attention as j_attention
from repro.models.transformer.model import lm_loss as j_lm_loss
from repro.train import AdamW as JAdamW
from repro.train import (load_checkpoint as j_load_ckpt,
                         save_checkpoint as j_save_ckpt)
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import synthetic_lm_batches
from repro_torch.graph.sampler import rng_from
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.models.transformer import (init_decode_state, init_params,
                                            lm_loss, make_train_step,
                                            params_from_numpy, serve_step)
from repro_torch.models.transformer.attention import attention
from repro_torch.train import AdamW, load_checkpoint, save_checkpoint
from repro_torch.train.optim import tree_leaves, tree_map
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
CHUNKS = dict(attn_q_chunk=8, attn_kv_chunk=16)
#: name -> (reduced architecture, options set on both packages' configs)
CONFIGS = {
    "smollm-360m": ("smollm-360m", {}),
    "gemma2-2b": ("gemma2-2b", {}),
    "granite-3-2b": ("granite-3-2b", {}),
    "qwen1.5-32b": ("qwen1.5-32b", {}),
    "smollm-360m-qk-norm": ("smollm-360m", {"qk_norm": True}),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "arctic-480b": ("arctic-480b", {}),
    # one (rglru, rglru, local) repeat and the two rglru tail blocks
    "recurrentgemma-9b-tail": ("recurrentgemma-9b", {"num_layers": 5}),
}
ADAMW = dict(lr=3e-4, weight_decay=0.01, max_grad_norm=1.0)


def _cfgs(name, **extra):
    arch, kw = CONFIGS[name]
    kw = {**kw, **CHUNKS, **extra}
    return (dataclasses.replace(get_reduced(arch), **kw),
            dataclasses.replace(j_get_reduced(arch), **kw))


def _jparams(jcfg, seed):
    """The reference's initial parameters with every zero-initialised
    leaf (norm scales, biases) filled from a seed too, so their
    gradients and the options they carry are exercised."""
    rng = rng_from(seed, 1)

    def fill(a):
        a = np.asarray(a)
        if not np.any(a):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, j_init(jcfg, jax.random.key(seed)))


def _batch(cfg, B=2, S=32, seed=3):
    """Tokens past the reduced gemma2 window of 16; a loss mask with
    zeros, so the masked mean is exercised."""
    rng = rng_from(seed, 2)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
            "loss_mask": mask}


def _paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _grads(cfg, tp, batch):
    p = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, aux = lm_loss(cfg, p, batch)
    it = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss, aux, tree_map(lambda _: next(it), tp)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_loss_and_grads_match_reference(name):
    cfg, jcfg = _cfgs(name)
    jp = _jparams(jcfg, 11)
    tp = params_from_numpy(jp)
    nb = _batch(cfg)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    fa0 = t_fa_ops.LAUNCHES.value
    loss, aux, tg = _grads(cfg, tp, {k: torch.from_numpy(v)
                                     for k, v in nb.items()})
    assert t_fa_ops.LAUNCHES.value == fa0
    assert loss.dtype == torch.float32 and aux["loss"] is loss
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    t_leaves = _paths(jax.tree.map(lambda t: t.numpy(), tg))
    j_leaves = _paths(jg)
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    assert any("bq" in jax.tree_util.keystr(p) for p, _ in j_leaves) == \
        cfg.qkv_bias
    assert any("q_norm" in jax.tree_util.keystr(p) for p, _ in j_leaves) \
        == cfg.qk_norm
    for (path, a), (_, b) in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", ["smollm-360m", "qwen1.5-32b"])
def test_adamw_steps_match_reference(name):
    """3 steps of the launcher's AdamW on the launcher's batches: the
    loss each step, both moments after the last, and the loss the final
    parameters give on a fourth batch. The parameters are held through
    that loss: AdamW divides each moment by its root, so a gradient
    element that is float32 noise (a few in 10^5) moves its parameter by
    a different fraction of ``lr`` in each package."""
    cfg, jcfg = _cfgs(name)
    jp = _jparams(jcfg, 12)
    tp = params_from_numpy(jp)
    jopt, opt = JAdamW(**ADAMW), AdamW(**ADAMW)

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda pp: j_lm_loss(jcfg, pp, b), has_aux=True)(p)
        p2, o2 = jopt.update(g, o, p)
        return p2, o2, loss

    step = make_train_step(cfg, opt)
    jo, to = jopt.init(jp), opt.init(tp)
    batches = list(zip(j_batches(jcfg, batch=2, seq=32, steps=4, s0=5),
                       synthetic_lm_batches(cfg, batch=2, seq=32, steps=4,
                                            s0=5)))
    for jb, tb in batches[:3]:
        np.testing.assert_array_equal(tb["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))
        jp, jo, jloss = jstep(jp, jo, jb)
        tp, to, aux = step(tp, to, tb)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), **TOL)
    assert int(to.step) == int(jo.step) == 3
    for t, j in ((to.mu, jo.mu), (to.nu, jo.nu)):
        for (path, a), (_, b) in zip(
                _paths(jax.tree.map(lambda x: x.numpy(), t)), _paths(j)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                       err_msg=jax.tree_util.keystr(path))
    jb, tb = batches[3]
    with torch.no_grad():
        np.testing.assert_allclose(lm_loss(cfg, tp, tb)[0].item(),
                                   float(j_lm_loss(jcfg, jp, jb)[0]), **TOL)


def test_full_width_layer_curve_matches_reference():
    """One granite-3-2b layer at its full width (d 2048, 32/8 heads, d_ff
    8192; vocabulary cut to 512) in float32: 4 steps of the launcher's
    AdamW, the loss each step against the reference's jitted step."""
    from repro.configs import get_arch as j_get_arch
    from repro_torch.configs import get_arch
    kw = dict(num_layers=1, vocab_size=512, dtype="float32")
    cfg = dataclasses.replace(get_arch("granite-3-2b"), **kw)
    jcfg = dataclasses.replace(j_get_arch("granite-3-2b"), **kw)
    jp = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(0)))
    tp = params_from_numpy(jp)
    jopt, opt = JAdamW(**ADAMW), AdamW(**ADAMW)

    @jax.jit
    def jstep(p, o, b):
        (loss, _), g = jax.value_and_grad(
            lambda pp: j_lm_loss(jcfg, pp, b), has_aux=True)(p)
        return (*jopt.update(g, o, p), loss)

    step = make_train_step(cfg, opt)
    jo, to = jopt.init(jp), opt.init(tp)
    for jb, tb in zip(j_batches(jcfg, batch=1, seq=64, steps=4, s0=0),
                      synthetic_lm_batches(cfg, batch=1, seq=64, steps=4,
                                           s0=0)):
        jp, jo, jloss = jstep(jp, jo, jb)
        tp, to, aux = step(tp, to, tb)
        np.testing.assert_allclose(aux["loss"].item(), float(jloss), **TOL)


def test_adamw_in_place_equals_functional_bit_for_bit():
    """``update(..., inplace=True)`` overwrites the parameters and moments
    with exactly what the functional update returns, in bfloat16 too."""
    gen = torch.Generator().manual_seed(0)

    def tree(dtype):
        return {"a": torch.randn((5, 3), generator=gen).to(dtype),
                "b": [torch.randn((7,), generator=gen).to(dtype)]}
    for dtype in (torch.float32, torch.bfloat16):
        params, grads = tree(dtype), tree(dtype)
        opt = AdamW(**ADAMW)
        state = opt.init(params)
        want_p, want_s = opt.update(grads, state, params)
        snapshot = tree_map(torch.clone, params)
        got_p, got_s = opt.update(grads, state, params, inplace=True)
        assert got_p["a"] is params["a"] and got_s.mu["a"] is state.mu["a"]
        for a, b in zip(tree_leaves((got_p, got_s)),
                        tree_leaves((want_p, want_s))):
            assert torch.equal(a, b)
        assert not torch.equal(params["a"], snapshot["a"])


@pytest.mark.parametrize("window,cap", [(12, 0.0), (0, 30.0), (12, 30.0)])
def test_chunked_attention_gradient_matches_reference(window, cap):
    """d/d(q, k, v) of a weighted sum of the chunked attention (``_banded``
    for a window), several q and kv chunks, GQA, against ``jax.grad``."""
    rng = rng_from(window, int(cap))
    B, S, H, kvH, dh = 2, 32, 6, 2, 16
    q, k, v = (rng.normal(size=(B, S, h, dh)).astype(np.float32)
               for h in (H, kvH, kvH))
    w = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    kw = dict(window=window, attn_softcap=cap, q_chunk=8, kv_chunk=16)
    want = jax.grad(lambda q, k, v: jnp.sum(j_attention(q, k, v, **kw) * w),
                    argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    (attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("name", ["qwen1.5-32b", "smollm-360m-qk-norm"])
def test_decode_with_qkv_bias_and_qk_norm_matches_reference(name):
    """``block_decode`` shares ``_project_qkv``: 12 decode steps' logits
    against the reference's ``serve_step``."""
    cfg, jcfg = _cfgs(name)
    jp = _jparams(jcfg, 13)
    tp = params_from_numpy(jp)
    B, S = 2, 12
    toks = rng_from(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, st, t, pos: j_serve_step(jcfg, p, st, t, pos))
    jst, tst = j_init_state(jcfg, B, max_len=S), init_decode_state(
        cfg, B, max_len=S)
    with torch.inference_mode():
        for t in range(S):
            jl, jst = jstep(jp, jst, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
            tl, tst = serve_step(cfg, tp, tst,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t, dtype=torch.int32))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)


def _train(name, steps=3, seed=0):
    """The launcher's run: batch 8 x 128, where each batch repeats most
    tokens many times over (Zipf), so the embedding's backward sums
    repeated rows."""
    cfg = get_reduced(CONFIGS[name][0])
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    opt = AdamW(**ADAMW)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    losses = []
    for batch in synthetic_lm_batches(cfg, batch=8, seq=128, steps=steps,
                                      s0=seed):
        params, state, aux = step(params, state, batch)
        losses.append(aux["loss"].item())
    return losses, params


@pytest.mark.parametrize("name", ["gemma2-2b", "granite-3-2b",
                                  "qwen1.5-32b"])
def test_two_fresh_runs_bit_equal(name):
    a_losses, a_params = _train(name)
    b_losses, b_params = _train(name)
    assert a_losses == b_losses
    for a, b in zip(tree_leaves(a_params), tree_leaves(b_params)):
        assert torch.equal(a, b)


def test_lm_launcher_trains_on_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--workload", "lm", "--device", "cpu", "--arch", "granite-3-2b",
          "--steps", "12", "--seq", "32"])
    out = capsys.readouterr().out
    assert "== lm granite-3-2b (reduced) on cpu == 12 steps" in out
    first, last = (float(x) for x in out.split("loss ")[-1].split(" -> "))
    assert last < first


def test_lm_launcher_raises_without_a_card(monkeypatch):
    from repro_torch.launch.train import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--workload", "lm", "--steps", "1"])


def test_lm_checkpoints_load_in_either_package(tmp_path):
    cfg, jcfg = _cfgs("qwen1.5-32b")
    jp = j_init(jcfg, jax.random.key(4))
    tp = params_from_numpy(_jparams(jcfg, 5))
    save_checkpoint(str(tmp_path / "port"), tp, step=7)
    got = j_load_ckpt(str(tmp_path / "port"), jp, expect_step=7)
    for (path, a), (_, b) in zip(
            _paths(got), _paths(jax.tree.map(lambda t: t.numpy(), tp))):
        np.testing.assert_array_equal(np.asarray(a), b,
                                      err_msg=jax.tree_util.keystr(path))
    j_save_ckpt(str(tmp_path / "jax"), jp, step=2)
    back = load_checkpoint(str(tmp_path / "jax"), tp, expect_step=2)
    assert isinstance(back["blocks"][0]["attn"]["bq"], torch.Tensor)
    for (path, a), (_, b) in zip(
            _paths(jax.tree.map(lambda t: t.numpy(), back)), _paths(jp)):
        np.testing.assert_array_equal(a, np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
