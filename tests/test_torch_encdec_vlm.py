"""The port's enc-dec model (seamless-m4t-medium) and M-RoPE model
(qwen2-vl-72b) against the JAX package, on the CPU.

Reduced configs in float32, parameters from the JAX ``init_params``
carried across with ``params_from_numpy`` (zero leaves filled from a
seed, so the norm scales and biases are exercised), inputs from numpy
seeds, within ``rtol=1e-4, atol=1e-5`` unless a test says otherwise:
``apply_mrope``; ``encode``; ``forward`` with ``enc_out``, and with
``embeds`` and M-RoPE streams; 16-step ``serve_step`` loops (cross
caches filled from the encoder, cross caches empty, M-RoPE streams);
``lm_loss`` and every gradient leaf against ``jax.value_and_grad``; the
``init_params`` tree; the plain ``flash_attention`` at Sq != Skv against
the JAX chunked ``attention(causal=False)``; the two launchers.

M-RoPE's three streams are made to differ (t, t // 8, t % 8: an 8-wide
patch grid, with an offset a sequence), since equal streams make M-RoPE
RoPE and hide a wrong section split or stream order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as j_get_arch
from repro.configs import get_reduced as j_get_reduced
from repro.models.transformer import (forward as j_forward,
                                      init_decode_state as j_init_state,
                                      init_params as j_init,
                                      serve_step as j_serve_step)
from repro.models.transformer.attention import attention as j_attention
from repro.models.transformer.common import apply_mrope as j_mrope
from repro.models.transformer.model import (encode as j_encode,
                                            lm_loss as j_lm_loss)
from repro_torch.configs import get_arch, get_reduced
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.transformer import (encode, forward,
                                            init_decode_state, init_params,
                                            lm_loss, params_from_numpy,
                                            serve_step)
from repro_torch.models.transformer.attention import attention
from repro_torch.models.transformer.common import apply_mrope, apply_rope
from repro_torch.train.optim import tree_leaves, tree_map
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
ENCDEC, VLM = "seamless-m4t-medium", "qwen2-vl-72b"
#: several attention chunks in the encoder and the decoder (the chunked
#: path needs S a multiple of each)
CHUNKS = dict(attn_q_chunk=16, attn_kv_chunk=16)
B, S, S_SRC = 2, 32, 48


def _cfgs(name, **kw):
    return (dataclasses.replace(get_reduced(name), **kw),
            dataclasses.replace(j_get_reduced(name), **kw))


def _jparams(jcfg, seed):
    """The reference's parameters as numpy, every zero leaf filled."""
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if not np.any(a):
            a = (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(fill, j_init(jcfg, jax.random.key(seed)))


def _streams(Bn, Sn, offset=0):
    """(3, B, S) int32 M-RoPE streams t, h, w of an 8-wide patch grid,
    each sequence shifted by its own offset."""
    t = np.arange(Sn)[None, :] + offset + 5 * np.arange(Bn)[:, None]
    return np.stack([t, t // 8, t % 8]).astype(np.int32)


def _frames(rng, Bn, Sn, d):
    """The frontend stubs' embeddings: 0.02 x normal, as the pipeline."""
    return (0.02 * rng.standard_normal((Bn, Sn, d))).astype(np.float32)


def _paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", [(4, 6, 6), (16, 24, 24)])
def test_apply_mrope_matches_reference(sections):
    dh = 2 * sum(sections)
    rng = np.random.default_rng(dh)
    x = rng.standard_normal((B, 20, 3, dh)).astype(np.float32)
    pos = _streams(B, 20, offset=1000)
    want = np.asarray(j_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections).numpy()
    # cos/sin of two libraries: within 1e-6 of each other (|x| < 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # each band reads its own stream: one stream moved moves its bands
    moved = pos.copy()
    moved[2] += 3
    got2 = apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), 1e6,
                       sections).numpy()
    w_bands = np.arange(dh // 2) >= sections[0] + sections[1]
    changed = np.abs(got2 - got).max(axis=(0, 1, 2)) > 0
    assert np.array_equal(changed, np.concatenate([w_bands, w_bands]))
    # equal streams: M-RoPE is RoPE, bit for bit
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_array_equal(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same.copy()), 1e6,
                    sections).numpy(),
        apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                   1e6).numpy())
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                    (4, 6, 7))


# ---------------------------------------------------------------------------
# the models: encode, forward, serve_step, lm_loss
# ---------------------------------------------------------------------------

def test_encode_matches_reference():
    cfg, jcfg = _cfgs(ENCDEC, **CHUNKS)
    jp = _jparams(jcfg, 1)
    tp = params_from_numpy(jp)
    emb = _frames(np.random.default_rng(2), B, S_SRC, cfg.d_model)
    want = np.asarray(jax.jit(lambda p, e: j_encode(jcfg, p, e))(
        jp, jnp.asarray(emb)))
    with torch.inference_mode():
        got = encode(cfg, tp, torch.from_numpy(emb))
    assert got.dtype == torch.float32 and got.shape == (B, S_SRC,
                                                        cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _forward_inputs(name, cfg, rng):
    """(reference kwargs, port kwargs) of ``forward`` beside the tokens:
    the encoder's output (S_src != S) or patch embeddings and M-RoPE
    streams."""
    if name == ENCDEC:
        enc = _frames(rng, B, S_SRC, cfg.d_model) * 50.0
        return ({"enc_out": jnp.asarray(enc)},
                {"enc_out": torch.from_numpy(enc)})
    emb = _frames(rng, B, S, cfg.d_model)
    pos = _streams(B, S)
    return ({"embeds": jnp.asarray(emb), "mrope_positions": jnp.asarray(pos)},
            {"embeds": torch.from_numpy(emb),
             "mrope_positions": torch.from_numpy(pos)})


@pytest.mark.parametrize("name", [ENCDEC, VLM])
def test_forward_matches_reference(name):
    cfg, jcfg = _cfgs(name, **CHUNKS)
    jp = _jparams(jcfg, 3)
    tp = params_from_numpy(jp)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = _forward_inputs(name, cfg, rng)
    want = np.asarray(jax.jit(lambda p, t, kw: j_forward(jcfg, p, t, **kw))(
        jp, jnp.asarray(toks), jkw))
    with torch.inference_mode():
        got = forward(cfg, tp, torch.from_numpy(toks), **tkw).numpy()
        plain = forward(cfg, tp, torch.from_numpy(toks)).numpy()
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    # the options are used: without them the logits are other ones
    assert np.abs(plain - got).max() > 1e-3


def _filled_cross(cfg, jp, enc_out, x_len):
    """Each decoder layer's cross caches, as a caller writes them:
    xk/xv = enc_out @ xattn.wk/wv (R, B, S_src, kvH, dh), x_len (R, B)."""
    xp = jp["blocks"][0]["xattn"]
    R = xp["wk"].shape[0]
    shape = (R,) + enc_out.shape[:2] + (cfg.num_kv_heads, cfg.head_dim)
    xk = np.einsum("bsd,rdk->rbsk", enc_out, xp["wk"]).reshape(shape)
    xv = np.einsum("bsd,rdk->rbsk", enc_out, xp["wv"]).reshape(shape)
    return {"xk": xk.astype(np.float32), "xv": xv.astype(np.float32),
            "x_len": np.broadcast_to(np.asarray(x_len, np.int32),
                                     (R, len(x_len))).copy()}


@pytest.mark.parametrize("case", ["encdec-filled", "encdec-empty",
                                  "encdec-src0", "mrope"])
def test_serve_step_loop_matches_reference(case):
    """16 decode steps from the same state on both sides: logits every
    step and the final caches. ``encdec-filled``: cross caches from the
    encoder with ragged lengths; ``encdec-empty``: the launchers' 8 empty
    source positions (``x_len = 0``), where the cross-attention adds
    exactly 0 (the same logits bit for bit as a state without cross
    caches); ``encdec-src0``: ``init_decode_state``'s default caches of
    no source positions, likewise, against the reference over 8 empty
    positions (its decode attention cannot take a source of none: a max
    over no keys); ``mrope``: distinct streams each step."""
    name = VLM if case == "mrope" else ENCDEC
    cfg, jcfg = _cfgs(name)
    jp = _jparams(jcfg, 5)
    tp = params_from_numpy(jp)
    rng = np.random.default_rng(6)
    steps = 16
    toks = rng.integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    src_len = {"encdec-filled": S_SRC, "encdec-src0": 0}.get(case, 8)
    jst = j_init_state(jcfg, B, max_len=steps, src_len=src_len or 8)
    tst = init_decode_state(cfg, B, max_len=steps, src_len=src_len)
    if case == "encdec-filled":
        enc = np.asarray(j_encode(jcfg, jp, jnp.asarray(
            _frames(rng, B, S_SRC, cfg.d_model))))
        cross = _filled_cross(cfg, jp, enc, [S_SRC, 29])
        jst["scan"][0].update({k: jnp.asarray(v) for k, v in cross.items()})
        for k, v in cross.items():
            tst["scan"][0][k].copy_(torch.from_numpy(v))
    bare = None
    if case in ("encdec-empty", "encdec-src0"):
        bare = init_decode_state(cfg, B, max_len=steps)
        for k in ("xk", "xv", "x_len"):
            del bare["scan"][0][k]
    streams = _streams(B, steps, offset=40)
    jstep = jax.jit(lambda p, st, t, pos, mp: j_serve_step(
        jcfg, p, st, t, pos, mrope_positions=mp))
    with torch.inference_mode():
        for t in range(steps):
            pos = np.full((B,), t, np.int32)
            mp = streams[:, :, t:t + 1] if case == "mrope" else None
            jl, jst = jstep(jp, jst, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(pos),
                            None if mp is None else jnp.asarray(mp))
            tl, tst = serve_step(
                cfg, tp, tst, torch.from_numpy(toks[:, t:t + 1]),
                torch.from_numpy(pos),
                mrope_positions=None if mp is None else torch.from_numpy(mp))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            if bare is not None:
                bl, bare = serve_step(cfg, tp, bare,
                                      torch.from_numpy(toks[:, t:t + 1]),
                                      torch.from_numpy(pos))
                assert torch.equal(bl, tl)
    for key, ts in tst["scan"][0].items():
        want = np.asarray(jst["scan"][0][key])
        if case == "encdec-src0" and key in ("xk", "xv"):
            assert ts.shape == want.shape[:2] + (0,) + want.shape[3:]
            continue
        np.testing.assert_allclose(ts.numpy(), want, **TOL)


def _batch(name, cfg, rng):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
           "loss_mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if name == ENCDEC:
        out["enc_embeds"] = _frames(rng, B, S_SRC, cfg.d_model)
    else:
        out["embeds"] = _frames(rng, B, S, cfg.d_model)
        out["mrope_positions"] = _streams(B, S)
    return out


@pytest.mark.parametrize("name", [ENCDEC, VLM])
def test_lm_loss_and_grads_match_reference(name):
    cfg, jcfg = _cfgs(name, **CHUNKS)
    jp = _jparams(jcfg, 7)
    tp = params_from_numpy(jp)
    nb = _batch(name, cfg, np.random.default_rng(8))
    (jloss, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_lm_loss(jcfg, p, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in nb.items()})
    p = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = lm_loss(cfg, p, {k: torch.from_numpy(v)
                               for k, v in nb.items()})
    it = iter(torch.autograd.grad(loss, tree_leaves(p)))
    tg = tree_map(lambda _: next(it), tp)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    t_leaves = _paths(jax.tree.map(lambda t: t.numpy(), tg))
    j_leaves = _paths(jg)
    assert [q for q, _ in t_leaves] == [q for q, _ in j_leaves]
    keys = " ".join(jax.tree_util.keystr(q) for q, _ in j_leaves)
    assert ("enc_blocks" in keys and "xattn" in keys) == (name == ENCDEC)
    for (path, a), (_, b) in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a, np.asarray(b), **TOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name,dtype", [(ENCDEC, "float32"),
                                        (ENCDEC, "bfloat16"),
                                        (VLM, "bfloat16")])
def test_init_params_tree_and_params_from_numpy(name, dtype):
    """The port's own draws have the reference's tree, shapes, dtypes and
    law; the reference's tree crosses bit for bit."""
    cfg, jcfg = _cfgs(name, dtype=dtype)
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    jp = jax.tree.map(np.asarray, j_init(jcfg, jax.random.key(0)))
    t_leaves = _paths(jax.tree.map(
        lambda t: t.float().numpy() if t.dtype == torch.bfloat16
        else t.numpy(), tp))
    j_leaves = _paths(jp)
    assert [q for q, _ in t_leaves] == [q for q, _ in j_leaves]
    for (path, a), (_, b), t in zip(t_leaves, j_leaves, tree_leaves(tp)):
        assert a.shape == b.shape, path
        assert str(t.dtype).split(".")[1] == str(b.dtype), path
        if np.any(b):       # dense_init: std fan_in ** -0.5
            assert abs(a.std() / b.astype(np.float32).std() - 1) < 0.1, path
        else:
            assert not np.any(a), path
    xattn = tp["blocks"][0].get("xattn", {})
    assert ("bq" not in xattn) and (bool(xattn) == (name == ENCDEC))
    back = params_from_numpy(jp)
    for (path, a), b in zip(j_leaves, tree_leaves(back)):
        assert np.array_equal(np.asarray(a, np.float32),
                              b.float().numpy()), path


def test_configs_match_reference():
    for name in (ENCDEC, VLM):
        assert dataclasses.asdict(get_arch(name)) == \
            dataclasses.asdict(j_get_arch(name))
        assert dataclasses.asdict(get_reduced(name)) == \
            dataclasses.asdict(j_get_reduced(name))
    seamless, vlm = get_arch(ENCDEC), get_arch(VLM)
    assert (seamless.kind, seamless.num_enc_layers, seamless.frontend) == \
        ("encdec", 12, "audio")
    assert (vlm.mrope_sections, vlm.frontend) == ((16, 24, 24), "vision")


# ---------------------------------------------------------------------------
# cross-attention: the kernel's plain version at Sq != Skv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skv", [24, 40, 37])
def test_flash_attention_cross_matches_reference_attention(skv):
    """Sq = 32 against Skv shorter, longer and ragged: the kernel's plain
    version, its wrapper on CPU tensors and the port's chunked CPU path
    against the reference's chunked ``attention(causal=False)``."""
    rng = np.random.default_rng(skv)
    H, kvH, dh = 4, 2, 16
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, skv, kvH, dh)).astype(np.float32)
    v = rng.standard_normal((B, skv, kvH, dh)).astype(np.float32)
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (flash_attention_ref(tq, tk, tv, causal=False),
                t_fa_ops.flash_attention(tq, tk, tv, causal=False),
                attention(tq, tk, tv, causal=False)):
        assert got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="only without a mask"):
            t_fa_ops.flash_attention(tq, tk, tv, **kw)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [ENCDEC, VLM])
def test_serve_decode_launcher_on_cpu(name, capsys):
    from repro_torch.launch.serve_decode import main
    main(["--device", "cpu", "--arch", name, "--batch", "2", "--prompt-len",
          "4", "--gen", "6"])
    out = capsys.readouterr().out
    assert f"== serve {name} (reduced) on cpu ==" in out
    assert "9 decode steps" in out and "sample token ids" in out


@pytest.mark.parametrize("name", [ENCDEC, VLM])
def test_lm_launcher_trains_on_cpu(name, capsys):
    from repro_torch.launch.train import main
    main(["--workload", "lm", "--device", "cpu", "--arch", name,
          "--steps", "8", "--seq", "32"])
    out = capsys.readouterr().out
    assert f"== lm {name} (reduced) on cpu == 8 steps" in out
    first, last = (float(x) for x in out.split("loss ")[-1].split(" -> "))
    assert last < first
