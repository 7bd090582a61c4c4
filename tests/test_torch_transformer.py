"""The port's transformer decode-serving slice against the JAX package,
on the CPU.

Kernels: the plain versions of ``flash_attention`` and ``flash_decode``
against the Pallas kernels in interpret mode, within the reference's
``rtol=1e-4, atol=1e-5`` (float32 outputs, and the float32 partials of
bfloat16 inputs). A bfloat16 attention output is a float32 value rounded
once to bfloat16 on both sides, from sums taken in another order, so the
two may land one bfloat16 step apart: it is held to ``rtol=2**-7`` (one
step is at most 2^-7 of the value). Units: ``rms_norm``,
``apply_rope``, tanh-GELU, the embedding scale. Blocks: ``block_apply``
and ``block_decode``. The slice: ``forward`` logits and a 32-step
``serve_step`` loop (logits, KV caches and the SSM/RG-LRU states) for
reduced gemma2-2b, smollm-360m, qwen3-moe-30b-a3b, mamba2-1.3b,
recurrentgemma-9b and arctic-480b from the JAX ``init_params`` output,
the port's own decode-against-prefill check, and the ``serve_decode``
launcher. The mixers' own tests are in ``test_torch_mixers.py``.
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

from repro.configs import get_reduced as j_get_reduced
from repro.kernels.flash_attention.ops import flash_attention as j_flash_attn
from repro.kernels.flash_decode.ops import (flash_decode as j_flash_decode,
                                            flash_decode_batched as
                                            j_flash_decode_batched)
from repro.models.transformer import (forward as j_forward,
                                      init_decode_state as j_init_state,
                                      init_params as j_init,
                                      serve_step as j_serve_step)
from repro.models.transformer.attention import attention as j_attention
from repro.models.transformer.blocks import (block_apply as j_block_apply,
                                             block_decode as j_block_decode,
                                             init_block_params as j_init_block)
from repro.models.transformer.common import (apply_rope as j_rope,
                                             rms_norm as j_rms_norm)
from repro_torch.configs import get_arch, get_reduced
from repro_torch.kernels.flash_attention import ops as t_fa_ops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.kernels.flash_decode.ref import combine, finalize
from repro_torch.models.transformer import (forward, init_decode_state,
                                            init_params, params_from_numpy,
                                            serve_step)
from repro_torch.models.transformer.attention import attention
from repro_torch.models.transformer.blocks import block_apply, block_decode
from repro_torch.models.transformer.common import apply_rope, rms_norm
from repro_torch.dist.mesh import make_mesh
from repro_torch.models.transformer.model import _embed, _unstack
from repro_torch.models.transformer.moe import moe_apply
from _torch_threads import capped_env

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rand(rng, shape, dtype=np.float32):
    return rng.normal(size=shape).astype(np.float32).astype(dtype)


def _pair(a, dtype):
    """numpy float32 -> (jax array, torch tensor) of ``dtype`` with the
    same values."""
    if dtype == "bfloat16":
        j = jnp.asarray(a, jnp.bfloat16)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
        return j, t
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# flash_attention: plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

ATTN_CASES = {
    # name: (G, dh, causal, window, softcap, dtype)
    "g1_dh64_causal": (1, 64, True, 0, 0.0, "float32"),
    "g2_dh64_causal_softcap": (2, 64, True, 0, 50.0, "float32"),
    "g3_dh48_window": (3, 48, True, 16, 0.0, "float32"),
    "g2_dh48_window_softcap": (2, 48, True, 16, 50.0, "float32"),
    "g3_dh64_noncausal": (3, 64, False, 0, 0.0, "float32"),
    "g1_dh48_noncausal_window_softcap": (1, 48, False, 24, 30.0, "float32"),
    "g2_dh64_causal_softcap_bf16": (2, 64, True, 0, 50.0, "bfloat16"),
    "g3_dh48_window_softcap_bf16": (3, 48, True, 16, 50.0, "bfloat16"),
    "g1_dh64_window_bf16": (1, 64, True, 16, 0.0, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_attention_plain_matches_pallas_interpret(name):
    G, dh, causal, window, cap, dtype = ATTN_CASES[name]
    rng = np.random.default_rng(len(name) * 31 + G)
    B, S, kvH = 2, 80, 2
    q, tq = _pair(_rand(rng, (B, S, kvH * G, dh)), dtype)
    k, tk = _pair(_rand(rng, (B, S, kvH, dh)), dtype)
    v, tv = _pair(_rand(rng, (B, S, kvH, dh)), dtype)
    want = j_flash_attn(q, k, v, causal=causal, window=window, softcap=cap,
                        use_kernel=True, interpret=True)
    got = t_fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                   softcap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(BF16_TOL if dtype == "bfloat16" else TOL))


@pytest.mark.parametrize("G", [2, 3])
def test_gqa_mapping_consecutive_q_heads_share_a_kv_head(G):
    """q head h reads kv head h // G: give each kv head its own constant
    value rows, so each q head's output names the kv head it read."""
    rng = np.random.default_rng(G)
    B, S, kvH, dh = 1, 24, 3, 16
    q = torch.from_numpy(_rand(rng, (B, S, kvH * G, dh)))
    k = torch.from_numpy(_rand(rng, (B, S, kvH, dh)))
    v = torch.arange(kvH, dtype=torch.float32)[None, None, :, None] \
        .expand(B, S, kvH, dh).contiguous()
    for out in (t_fa_ops.flash_attention(q, k, v),
                attention(q, k, v)):
        heads = out[0, :, :, 0]                           # (S, H)
        want = (torch.arange(kvH * G) // G).float()
        assert torch.allclose(heads, want.expand_as(heads), atol=1e-6)
    acc, _, l = t_fd_ops.flash_decode(q[0, 5], k[0], v[0],
                                      torch.tensor(24, dtype=torch.int32))
    assert torch.allclose(finalize(acc, l)[:, 0],
                          (torch.arange(kvH * G) // G).float(), atol=1e-6)


@pytest.mark.parametrize("window,cap,dtype", [
    (0, 0.0, "float32"), (12, 50.0, "float32"), (0, 30.0, "bfloat16"),
    (12, 0.0, "bfloat16")])
def test_chunked_attention_matches_reference_attention(window, cap, dtype):
    """The port's CPU attention (chunked online softmax, ``_banded`` for a
    window) against the reference's, with several q and kv chunks.
    Both scale q in its input dtype before the float32 cast."""
    rng = np.random.default_rng(window + int(cap))
    B, S, H, kvH, dh = 2, 32, 6, 2, 16
    q, tq = _pair(_rand(rng, (B, S, H, dh)), dtype)
    k, tk = _pair(_rand(rng, (B, S, kvH, dh)), dtype)
    v, tv = _pair(_rand(rng, (B, S, kvH, dh)), dtype)
    kw = dict(window=window, attn_softcap=cap, q_chunk=8, kv_chunk=16)
    want = j_attention(q, k, v, **kw)
    got = attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **(BF16_TOL if dtype == "bfloat16" else TOL))
    if dtype == "float32":
        # in float32 the kernel's plain version computes the same function
        np.testing.assert_allclose(
            flash_attention_ref(tq, tk, tv, window=window,
                                softcap=cap).numpy(), got.numpy(), **TOL)


# ---------------------------------------------------------------------------
# flash_decode: plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # name: (H, kvH, dh, S, length, start, softcap, dtype)
    "g2_partial_length": (4, 2, 64, 256, 200, None, 0.0, "float32"),
    "g3_full_length_start_softcap": (6, 2, 48, 128, 128, 40, 50.0, "float32"),
    "length_zero": (8, 4, 64, 128, 0, None, 0.0, "float32"),
    "start_equals_length": (2, 1, 48, 96, 50, 50, 0.0, "float32"),
    "g1_length_one_bf16": (4, 4, 64, 64, 1, 0, 30.0, "bfloat16"),
    "g3_window_softcap_bf16": (6, 2, 64, 512, 300, 150, 50.0, "bfloat16"),
    "g16_mqa_dh256_bf16": (16, 1, 256, 64, 40, 0, 0.0, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_flash_decode_plain_matches_pallas_interpret(name):
    H, kvH, dh, S, length, start, cap, dtype = DECODE_CASES[name]
    rng = np.random.default_rng(len(name) + S)
    q, tq = _pair(_rand(rng, (H, dh)), dtype)
    k, tk = _pair(_rand(rng, (S, kvH, dh)), dtype)
    v, tv = _pair(_rand(rng, (S, kvH, dh)), dtype)
    jl = jnp.asarray(length, jnp.int32)
    js = None if start is None else jnp.asarray(start, jnp.int32)
    want = j_flash_decode(q, k, v, jl, js, softcap=cap, use_kernel=True,
                          interpret=True)
    tl = torch.tensor(length, dtype=torch.int32)
    ts = None if start is None else torch.tensor(start, dtype=torch.int32)
    got = t_fd_ops.flash_decode(tq, tk, tv, tl, ts, softcap=cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    n_valid = max(0, length - (start or 0))
    if n_valid == 0:
        # NEG_INF masking: no valid position -> m = -1e30, l = 0, out 0
        assert torch.all(got[1] == -1e30) and torch.all(got[2] == 0)
        assert torch.all(finalize(got[0], got[2]) == 0)


def test_flash_decode_combine_over_shards_matches_unsharded():
    rng = np.random.default_rng(9)
    H, kvH, dh, S = 8, 2, 64, 1024
    q = torch.from_numpy(_rand(rng, (H, dh)))
    k = torch.from_numpy(_rand(rng, (S, kvH, dh)))
    v = torch.from_numpy(_rand(rng, (S, kvH, dh)))
    ln = 777
    j_full = j_flash_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                            jnp.asarray(v.numpy()), jnp.asarray(ln, jnp.int32),
                            softcap=50.0, use_kernel=True, interpret=True)
    full = t_fd_ops.flash_decode(q, k, v, torch.tensor(ln, dtype=torch.int32),
                                 softcap=50.0)
    want = finalize(full[0], full[2])
    np.testing.assert_allclose(
        want.numpy(), np.asarray(j_full[0] / j_full[2][:, None]), **TOL)
    for shards in (2, 4, 8):
        step = S // shards
        parts = [t_fd_ops.flash_decode(
            q, k[i * step:(i + 1) * step], v[i * step:(i + 1) * step],
            torch.tensor(np.clip(ln - i * step, 0, step), dtype=torch.int32),
            softcap=50.0)
            for i in range(shards)]
        acc, m, l = combine(parts)
        np.testing.assert_allclose(m.numpy(), full[1].numpy(), **TOL)
        np.testing.assert_allclose(finalize(acc, l).numpy(), want.numpy(),
                                   **TOL)


def test_flash_decode_batched_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    B, H, kvH, dh, S = 3, 6, 2, 48, 64
    q = _rand(rng, (B, H, dh))
    k = _rand(rng, (B, S, kvH, dh))
    v = _rand(rng, (B, S, kvH, dh))
    length = np.array([64, 0, 17], np.int32)
    start = np.array([10, 0, 17], np.int32)
    want = j_flash_decode_batched(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(length),
        jnp.asarray(start), softcap=50.0, use_kernel=True, interpret=True)
    got = t_fd_ops.flash_decode_batched(
        *map(torch.from_numpy, (q, k, v, length, start)), softcap=50.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.all(got[1:] == 0)          # length 0; start == length


def test_device_ids_and_lengths_stay_int32():
    q, k = torch.zeros(2, 8), torch.zeros(4, 1, 8)
    with pytest.raises(ValueError, match="int32"):
        t_fd_ops.flash_decode(q, k, k, torch.tensor(3))          # int64
    cfg = get_reduced("smollm-360m")
    st = init_decode_state(cfg, 2, max_len=4)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        serve_step(cfg, params, st, torch.zeros((2, 1), dtype=torch.int32),
                   torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def test_rms_norm_scales_by_one_plus_scale_in_float32():
    rng = np.random.default_rng(0)
    x, s = _rand(rng, (3, 5, 40)), _rand(rng, (40,))
    want = j_rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ones = rms_norm(torch.from_numpy(x), torch.zeros(40))
    assert torch.allclose(ones.square().mean(-1), torch.ones(3, 5),
                          rtol=1e-3)


def test_rope_rotates_split_halves():
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 3, 16))
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    want = j_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # position 1, frequency 1 on (x_j, x_{j+dh/2}) pairs, not (x_2j, x_2j+1)
    e = torch.zeros(1, 1, 1, 16)
    e[..., 0] = 1.0
    r = apply_rope(e, torch.ones(1, 1, dtype=torch.int32), 10000.0)
    assert torch.allclose(r[0, 0, 0, 8], torch.sin(torch.tensor(1.0)))
    assert r[0, 0, 0, 1] == 0


def test_gelu_is_the_tanh_approximation():
    cfg = get_reduced("gemma2-2b")
    x = np.linspace(-6, 6, 101).astype(np.float32)
    got = cfg.activation()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               **TOL)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(got - exact).max() > 1e-5


def test_embedding_scale_rounds_in_the_model_dtype():
    cfg = dataclasses.replace(get_reduced("smollm-360m"), embed_scale=True,
                              dtype="bfloat16")
    rng = np.random.default_rng(4)
    emb = _rand(rng, (cfg.padded_vocab, cfg.d_model))
    toks = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    je = jnp.asarray(emb, jnp.bfloat16)
    want = je[toks] * jnp.asarray(np.sqrt(cfg.d_model), jnp.bfloat16)
    got = _embed(cfg, {"embed": torch.from_numpy(
        np.array(je.astype(jnp.float32))).to(torch.bfloat16)},
        torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _perturb_zeros(tree, rng):
    """Norm scales start at zero; give them values."""
    return jax.tree.map(
        lambda a: (0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        if not np.any(a) else a, tree)


@pytest.mark.parametrize("name,kind", [("gemma2-2b", "local"),
                                       ("gemma2-2b", "attn"),
                                       ("smollm-360m", "attn")])
def test_block_apply_and_block_decode_match_reference(name, kind):
    cfg, jcfg = get_reduced(name), j_get_reduced(name)
    rng = np.random.default_rng(7)
    jp = _perturb_zeros(_np_tree(j_init_block(
        jcfg, kind, jax.random.key(3), jnp.float32)), rng)
    tp = params_from_numpy(jp)
    B, S = 2, 32
    x = _rand(rng, (B, S, cfg.d_model))
    pos = np.arange(S, dtype=np.int32)[None, :]
    want = jax.jit(lambda p, x, pos: j_block_apply(
        jcfg, kind, p, x, positions=pos))(jp, jnp.asarray(x),
                                          jnp.asarray(pos))
    got = block_apply(cfg, kind, tp, torch.from_numpy(x),
                      positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    # one decode step at position 20 into a cache holding other rows: the
    # local layer's 16-slot ring wraps (slot 4)
    S_cache = cfg.window if kind == "local" else S
    kc = _rand(rng, (B, S_cache, cfg.num_kv_heads, cfg.head_dim))
    vc = _rand(rng, (B, S_cache, cfg.num_kv_heads, cfg.head_dim))
    x1 = _rand(rng, (B, 1, cfg.d_model))
    p1 = np.array([20, 9], np.int32)
    want, wst = jax.jit(lambda p, x, st, pos: j_block_decode(
        jcfg, kind, p, x, st, pos=pos, positions=pos[:, None]))(
        jp, jnp.asarray(x1), {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(p1))
    tst = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, gst = block_decode(cfg, kind, tp, torch.from_numpy(x1), tst,
                            pos=torch.from_numpy(p1),
                            positions=torch.from_numpy(p1[:, None]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(gst[key].numpy(), np.asarray(wst[key]),
                                   **TOL)
        assert gst[key] is tst[key]          # written in place


# ---------------------------------------------------------------------------
# the slice: forward and the serve_step loop from the reference's params
# ---------------------------------------------------------------------------

#: logits tolerance, float32 on both sides (logits up to about 10).
#: Measured max abs error on the CPU: forward 4.2e-06 (gemma2-2b),
#: 6.2e-06 (smollm-360m), 4.8e-06 (vocab 500); the 32-step decode 4.8e-06
#: and 6.6e-06 against the reference, 3.8e-06 and 3.6e-06 against the
#: port's own forward
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _slice_cfg(name):
    if name == "gemma2-2b-vocab500":     # padded_vocab 512 > vocab 500
        return (dataclasses.replace(get_reduced("gemma2-2b"), vocab_size=500),
                dataclasses.replace(j_get_reduced("gemma2-2b"),
                                    vocab_size=500))
    if name == "recurrentgemma-9b-tail":  # 1 repeat + 2 rglru tail blocks
        return (dataclasses.replace(get_reduced("recurrentgemma-9b"),
                                    num_layers=5),
                dataclasses.replace(j_get_reduced("recurrentgemma-9b"),
                                    num_layers=5))
    return get_reduced(name), j_get_reduced(name)


#: the reduced configs of the MoE, SSM and hybrid RG-LRU families, and
#: recurrentgemma at 5 layers so that its two tail blocks run
MIXER_ARCHS = ["qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b",
               "arctic-480b", "recurrentgemma-9b-tail"]


@pytest.mark.parametrize("name", ["gemma2-2b", "smollm-360m",
                                  "gemma2-2b-vocab500"] + MIXER_ARCHS)
def test_forward_logits_match_reference(name):
    cfg, jcfg = _slice_cfg(name)
    assert cfg == dataclasses.replace(jcfg) or cfg.name == jcfg.name
    jp = _np_tree(j_init(jcfg, jax.random.key(0)))
    tp = params_from_numpy(jp)
    B, S = 2, 32                         # past the reduced window of 16
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    want = np.asarray(j_forward(jcfg, jp, jnp.asarray(toks)))
    with torch.inference_mode():
        got = forward(cfg, tp, torch.from_numpy(toks)).numpy()
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


@pytest.mark.parametrize("name", ["gemma2-2b", "smollm-360m"]
                         + MIXER_ARCHS)
def test_serve_step_loop_matches_reference_and_forward(name):
    """32 decode steps: every step's logits and the final KV caches and
    SSM/RG-LRU states against the reference's ``serve_step`` (the gemma2
    and recurrentgemma local layers' 16-slot rings wrap at step 16), and
    the decode logits against the port's own ``forward`` of the same
    tokens."""
    cfg, jcfg = _slice_cfg(name)
    jp = _np_tree(j_init(jcfg, jax.random.key(1)))
    tp = params_from_numpy(jp)
    B, S = 2, 32
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    jstep = jax.jit(lambda p, st, t, pos: j_serve_step(jcfg, p, st, t, pos))
    jst = j_init_state(jcfg, B, max_len=S)
    tst = init_decode_state(cfg, B, max_len=S)
    if cfg.window:
        local = cfg.pattern.index("local")
        assert tst["scan"][local]["k"].shape[2] == cfg.window < S
    assert len(tst["tail"]) == len(jst["tail"]) == len(cfg.tail)
    assert (name == "recurrentgemma-9b-tail") == (cfg.tail == ("rglru",) * 2)
    dec = []
    with torch.inference_mode():
        for t in range(S):
            jl, jst = jstep(jp, jst, jnp.asarray(toks[:, t:t + 1]),
                            jnp.full((B,), t, jnp.int32))
            tl, tst = serve_step(cfg, tp, tst,
                                 torch.from_numpy(toks[:, t:t + 1]),
                                 torch.full((B,), t, dtype=torch.int32))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            dec.append(tl[:, 0])
        for js, ts in zip(jst["scan"] + jst["tail"],
                          tst["scan"] + tst["tail"]):
            assert sorted(ts) == sorted(js)
            for key in ts:
                assert ts[key].dtype == torch.float32
                np.testing.assert_allclose(ts[key].numpy(),
                                           np.asarray(js[key]), **TOL)
        full = forward(cfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               **LOGIT_TOL)


def test_init_params_layout_and_law():
    for name in ("gemma2-2b", "smollm-360m"):
        cfg = get_reduced(name)
        tp = init_params(cfg, torch.Generator().manual_seed(0))
        jp = _np_tree(j_init(j_get_reduced(name), jax.random.key(0)))
        t_leaves = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), tp))[0]
        j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
        assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
        for (path, a), (_, b) in zip(t_leaves, j_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if np.any(b):       # dense_init: std fan_in ** -0.5
                assert abs(a.std() / b.std() - 1) < 0.1, path
            else:
                assert not np.any(a), path
    again = init_params(cfg, torch.Generator().manual_seed(0))
    assert torch.equal(again["embed"], tp["embed"])
    assert get_arch("gemma2-2b").window == 4096


def test_unported_options_raise():
    """The registry's last two names and the four options of Queue 1 item
    3 (enc-dec, M-RoPE, the audio and vision frontends) build and run;
    ``moe_apply`` over a mesh of one model shard is ``moe_apply`` without
    one, and over model shards that do not split the experts it raises
    (the expert-parallel forms: ``test_torch_sharding.py``); an unknown
    block kind raises."""
    for name in ("seamless-m4t-medium", "qwen2-vl-72b"):
        assert get_reduced(name).name == get_arch(name).name == name
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for kw in (dict(kind="encdec", num_enc_layers=2),
               dict(mrope_sections=(8, 8, 8)), dict(frontend="audio"),
               dict(frontend="vision")):
        cfg = dataclasses.replace(get_reduced("smollm-360m"), **kw)
        p = init_params(cfg, torch.Generator().manual_seed(0))
        assert ("enc_blocks" in p) == (cfg.kind == "encdec")
        with torch.inference_mode():
            logits = forward(cfg, p, toks)
        assert logits.shape == (1, 4, cfg.vocab_size)
    cfg = get_reduced("qwen3-moe-30b-a3b")
    p = init_params(cfg, torch.Generator().manual_seed(0))
    moe = _unstack(p["blocks"][0])[0]["moe"]
    x = torch.randn((1, 4, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        moe_apply(moe, x, cfg, mesh=make_mesh((2,), ("data",),
                                              device="cpu")),
        moe_apply(moe, x, cfg))
    with pytest.raises(ValueError, match="do not split over 3"):
        moe_apply(moe, x, cfg, mesh=make_mesh((1, 3), ("data", "model"),
                                              device="cpu"))
    with pytest.raises(ValueError, match="unknown block kind"):
        init_params(dataclasses.replace(cfg, pattern=("conv",)),
                    torch.Generator().manual_seed(0))


def test_serve_decode_launcher_on_cpu():
    env = capped_env(PYTHONPATH=str(REPO / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_decode", "--device",
         "cpu", "--arch", "gemma2-2b", "--batch", "2", "--prompt-len", "8",
         "--gen", "12"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "== serve gemma2-2b (reduced) on cpu ==" in p.stdout
    assert "19 decode steps" in p.stdout and "sample token ids" in p.stdout
