"""The port's MoE, SSD (mamba2) and RG-LRU (Griffin) modules against the
JAX package, on the CPU.

Each test feeds the same seeded numpy inputs (and the reference's own
initial parameters, carried with ``params_from_numpy``) through the JAX
function and the port's, float32 on both sides, within the reference's
cross-program tolerance ``rtol=1e-4, atol=1e-5``: the SSD chunk loop and
the RG-LRU doubling scan associate their sums and products in another
order than XLA does, which moves float32 results by a few 1e-7 here.
Against a sequential loop (numpy, the reference's unit test) the scans
are held to the same tolerance. The model-level tests are in
``test_torch_transformer.py`` and ``test_torch_lm_train.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as j_get_reduced
from repro.models.transformer import init_params as j_init
from repro.models.transformer.blocks import (block_apply as j_block_apply,
                                             block_decode as j_block_decode,
                                             init_block_params as j_init_block)
from repro.models.transformer.moe import (capacity as j_capacity,
                                          init_moe_params as j_init_moe,
                                          moe_local as j_moe_local)
from repro.models.transformer.rglru import (init_rglru_params as j_init_lru,
                                            rglru_decode_step as j_lru_step,
                                            rglru_forward as j_lru_forward,
                                            rglru_scan as j_lru_scan)
from repro.models.transformer.ssm import (init_ssm_params as j_init_ssm,
                                          ssd_scan as j_ssd_scan,
                                          ssm_decode_step as j_ssm_step,
                                          ssm_forward as j_ssm_forward)
from repro_torch.configs import get_reduced
from repro_torch.models.transformer import init_params, params_from_numpy
from repro_torch.models.transformer.blocks import (block_apply, block_decode,
                                                   init_block_params)
from repro_torch.models.transformer.common import dense_init
from repro_torch.models.transformer.model import _map
from repro_torch.models.transformer.moe import capacity, moe_local
from repro_torch.models.transformer.rglru import (_gates, rglru_decode_step,
                                                  rglru_forward, rglru_scan)
from repro_torch.models.transformer.ssm import (ssd_scan, ssm_decode_step,
                                                ssm_forward)
import _torch_threads  # noqa: F401  (torch's threads capped in a worker)

TOL = dict(rtol=1e-4, atol=1e-5)
NEW_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-1.3b", "recurrentgemma-9b",
             "arctic-480b")
#: recurrentgemma-9b reduced to 5 layers: one (rglru, rglru, local)
#: repeat and two rglru tail blocks, as the full model ends
TAIL_CASE = "recurrentgemma-9b-tail"


def _arch(name):
    """(reduced architecture, extra config fields) of a case name."""
    if name == TAIL_CASE:
        return "recurrentgemma-9b", {"num_layers": 5}
    return name, {}


def _rand(rng, shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _params(init, cfg, seed):
    """The reference's parameters of one module, with its zero leaves
    (biases, norm scales) filled from the seed, as numpy and as the
    port's tensors."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(
        lambda a: _rand(rng, a.shape, 0.1) if not np.any(np.asarray(a))
        else np.asarray(a), init(cfg, jax.random.key(seed)))
    return jp, params_from_numpy(jp)


# ---------------------------------------------------------------------------
# SSD (mamba2)
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, b=2, S=32, h=3, p=8, n=4):
    rng = np.random.default_rng(seed)
    return (_rand(rng, (b, S, h, p)),
            -np.abs(_rand(rng, (b, S, h))) * 0.5,
            _rand(rng, (b, S, n)), _rand(rng, (b, S, n)),
            _rand(rng, (b, h, p, n)))


@pytest.mark.parametrize("chunk", [4, 8, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_scan_matches_reference_and_recurrence(chunk, with_state):
    x, dA, B_, C_, h0 = _ssd_inputs(chunk)
    init = h0 if with_state else None
    wy, wfin = jax.jit(j_ssd_scan, static_argnums=4)(
        *map(jnp.asarray, (x, dA, B_, C_)), chunk,
        None if init is None else jnp.asarray(init))
    y, fin = ssd_scan(*_t(x, dA, B_, C_), chunk,
                      None if init is None else torch.from_numpy(init))
    _close(y, wy)
    _close(fin, wfin)
    # the naive recurrence, token by token
    st = h0.astype(np.float64) if with_state else np.zeros_like(h0, np.float64)
    for t in range(x.shape[1]):
        st = st * np.exp(dA[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], B_[:, t])
        np.testing.assert_allclose(
            y[:, t].numpy(), np.einsum("bhpn,bn->bhp", st, C_[:, t]), **TOL)
    np.testing.assert_allclose(fin.numpy(), st, **TOL)


def test_ssd_scan_refuses_a_ragged_chunk():
    x, dA, B_, C_, _ = _ssd_inputs(0, S=12)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(*_t(x, dA, B_, C_), 8)


def test_ssm_forward_and_decode_step_match_reference():
    cfg, jcfg = get_reduced("mamba2-1.3b"), j_get_reduced("mamba2-1.3b")
    jp, tp = _params(j_init_ssm, jcfg, 1)
    rng = np.random.default_rng(2)
    x = _rand(rng, (2, 32, cfg.d_model))
    _close(ssm_forward(tp, torch.from_numpy(x), cfg),
           jax.jit(lambda p, x: j_ssm_forward(p, x, jcfg))(jp, x))
    conv = _rand(rng, (2, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state))
    ssm = _rand(rng, (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state))
    x1 = _rand(rng, (2, 1, cfg.d_model))
    want = jax.jit(lambda *a: j_ssm_step(*a, jcfg))(jp, x1, conv, ssm)
    got = ssm_decode_step(tp, *_t(x1, conv, ssm), cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


# ---------------------------------------------------------------------------
# RG-LRU (Griffin)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 24, 37])
def test_rglru_scan_matches_reference_and_sequential(S):
    cfg, jcfg = (get_reduced("recurrentgemma-9b"),
                 j_get_reduced("recurrentgemma-9b"))
    jp, tp = _params(j_init_lru, jcfg, 3)
    rng = np.random.default_rng(S)
    w = cfg.lru_width
    u, h0 = _rand(rng, (2, S, w)), _rand(rng, (2, w))
    for init in (None, h0):
        jinit = None if init is None else jnp.asarray(init)
        wh, wlast = jax.jit(j_lru_scan)(jp, jnp.asarray(u), jinit)
        h, last = rglru_scan(tp, torch.from_numpy(u),
                             None if init is None else torch.from_numpy(init))
        _close(h, wh)
        _close(last, wlast)
    # the recurrence, token by token, from the port's own gates
    a, b = (t.numpy() for t in _gates(tp, torch.from_numpy(u)))
    hs = h0.astype(np.float64)
    for t in range(S):
        hs = a[:, t] * hs + b[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), hs, **TOL)


def test_rglru_forward_and_decode_step_match_reference():
    cfg, jcfg = (get_reduced("recurrentgemma-9b"),
                 j_get_reduced("recurrentgemma-9b"))
    jp, tp = _params(j_init_lru, jcfg, 4)
    rng = np.random.default_rng(5)
    x = _rand(rng, (2, 24, cfg.d_model))
    _close(rglru_forward(tp, torch.from_numpy(x), cfg),
           jax.jit(lambda p, x: j_lru_forward(p, x, jcfg))(jp, x))
    conv = _rand(rng, (2, cfg.ssm_conv - 1, cfg.lru_width))
    hs = _rand(rng, (2, cfg.lru_width))
    x1 = _rand(rng, (2, 1, cfg.d_model))
    want = jax.jit(lambda *a: j_lru_step(*a, jcfg))(jp, x1, conv, hs)
    got = rglru_decode_step(tp, *_t(x1, conv, hs), cfg)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _j_moe(jp, x, jcfg):
    """The reference's ``moe_local`` over every expert, jitted."""
    return jax.jit(lambda p, x: j_moe_local(p, x, jcfg, 0,
                                            jcfg.num_experts))(jp, x)

@pytest.mark.parametrize("name,T", [("qwen3-moe-30b-a3b", 24),
                                    ("arctic-480b", 24),
                                    ("qwen3-moe-30b-a3b", 3)])
def test_moe_local_matches_reference(name, T):
    cfg, jcfg = get_reduced(name), j_get_reduced(name)
    jp, tp = _params(j_init_moe, jcfg, 6)
    x = _rand(np.random.default_rng(T), (T, cfg.d_model))
    assert capacity(cfg, T) == j_capacity(jcfg, T)
    _close(moe_local(tp, torch.from_numpy(x), cfg, 0, cfg.num_experts),
           _j_moe(jp, x, jcfg))


def test_moe_partial_sums_over_expert_ranges_equal_the_whole():
    """The expert-parallel identity: partial outputs over disjoint expert
    ranges, each at the whole's capacity, add up to the whole."""
    kw = dict(d_model=16, moe=True, num_experts=8, top_k=2, moe_d_ff=8,
              capacity_factor=4.0, dtype="float32")
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"), **kw)
    jcfg = dataclasses.replace(j_get_reduced("qwen3-moe-30b-a3b"), **kw)
    jp, tp = _params(j_init_moe, jcfg, 7)
    x = torch.from_numpy(_rand(np.random.default_rng(8), (12, 16)))
    full = moe_local(tp, x, cfg, 0, 8)
    _close(full, _j_moe(jp, x.numpy(), jcfg))
    for width in (4, 2):
        parts = []
        for off in range(0, 8, width):
            sliced = dict(tp, **{w: tp[w][off:off + width]
                                 for w in ("w1", "w2", "w3")})
            parts.append(moe_local(sliced, x, cfg, off, width,
                                   cap=capacity(cfg, 12)))
        _close(sum(parts), full.numpy())


def test_moe_capacity_drops_match_reference():
    """capacity_factor=1.0 over skewed tokens: choices past an expert's
    C slots are dropped, the same ones as the reference drops."""
    kw = dict(capacity_factor=1.0)
    cfg = dataclasses.replace(get_reduced("qwen3-moe-30b-a3b"), **kw)
    jcfg = dataclasses.replace(j_get_reduced("qwen3-moe-30b-a3b"), **kw)
    jp, tp = _params(j_init_moe, jcfg, 9)
    rng = np.random.default_rng(10)
    T = 32
    # tokens near one direction crowd the same experts
    x = _rand(rng, (1, cfg.d_model)) + 0.3 * _rand(rng, (T, cfg.d_model))
    C = capacity(cfg, T)
    assert C == j_capacity(jcfg, T) == 16
    got = moe_local(tp, torch.from_numpy(x), cfg, 0, cfg.num_experts)
    want = _j_moe(jp, x, jcfg)
    _close(got, want)
    roomy = moe_local(tp, torch.from_numpy(x), cfg, 0, cfg.num_experts,
                      cap=T * cfg.top_k)
    dropped = (got - roomy).abs().amax(-1) > 1e-6
    assert 0 < int(dropped.sum()) < T       # some tokens lost a choice
    # the dropped rows are the last arrivals: a token's output changes
    # only where an earlier token filled its expert's queue
    assert not bool(dropped[:C // cfg.top_k].any())


# ---------------------------------------------------------------------------
# blocks: the new kinds, decode states written in place
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kind", [("mamba2-1.3b", "ssm"),
                                       ("recurrentgemma-9b", "rglru"),
                                       ("arctic-480b", "attn")])
def test_block_apply_and_decode_new_kinds_match_reference(name, kind):
    cfg, jcfg = get_reduced(name), j_get_reduced(name)
    jp, tp = _params(lambda c, k: j_init_block(c, kind, k, jnp.float32),
                     jcfg, 11)
    rng = np.random.default_rng(12)
    B, S = 2, 16
    x = _rand(rng, (B, S, cfg.d_model))
    pos = np.arange(S, dtype=np.int32)[None, :]
    _close(block_apply(cfg, kind, tp, torch.from_numpy(x),
                       positions=torch.from_numpy(pos)),
           jax.jit(lambda p, x, pos: j_block_apply(
               jcfg, kind, p, x, positions=pos))(jp, x, pos))
    if kind == "ssm":
        st = {"conv": _rand(rng, (B, 3, cfg.d_inner + 2 * cfg.ssm_state)),
              "ssm": _rand(rng, (B, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state))}
    elif kind == "rglru":
        st = {"conv": _rand(rng, (B, 3, cfg.lru_width)),
              "h": _rand(rng, (B, cfg.lru_width))}
    else:
        st = {k: _rand(rng, (B, S, cfg.num_kv_heads, cfg.head_dim))
              for k in ("k", "v")}
    x1 = _rand(rng, (B, 1, cfg.d_model))
    p1 = np.array([9, 4], np.int32)
    want, wst = jax.jit(lambda p, x, st, pos: j_block_decode(
        jcfg, kind, p, x, st, pos=pos, positions=pos[:, None]))(
            jp, x1, st, p1)
    tst = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, gst = block_decode(cfg, kind, tp, torch.from_numpy(x1), tst,
                            pos=torch.from_numpy(p1),
                            positions=torch.from_numpy(p1[:, None]))
    _close(got, want)
    for key in st:
        _close(gst[key], wst[key])
        assert gst[key] is tst[key]          # written in place


# ---------------------------------------------------------------------------
# parameters: layout, dtypes, carrying, the stacked init
# ---------------------------------------------------------------------------

def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NEW_ARCHS + (TAIL_CASE,))
def test_init_params_layout_dtypes_and_carry(name, dtype):
    """The port's ``init_params`` has the reference's tree, shapes and
    dtypes leaf by leaf (the mixers' float32 leaves stay float32 in a
    bfloat16 model); random leaves have the reference's spread and
    deterministic ones its values; ``params_from_numpy`` carries the
    reference's leaves bit for bit, each in its own dtype."""
    arch, kw = _arch(name)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype, **kw)
    jcfg = dataclasses.replace(j_get_reduced(arch), dtype=dtype, **kw)
    assert len(cfg.tail) == (2 if name == TAIL_CASE else 0)
    tp = init_params(cfg, torch.Generator().manual_seed(0))
    jp = j_init(jcfg, jax.random.key(0))
    jp2 = j_init(jcfg, jax.random.key(1))
    as_np = jax.tree.map(lambda t: t.float().numpy(), tp)
    t_leaves, j_leaves = _leaves(as_np), _leaves(jp)
    assert [p for p, _ in t_leaves] == [p for p, _ in j_leaves]
    dtypes = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
    j_dtypes = [str(b.dtype) for _, b in j_leaves]
    assert [dtypes[t.dtype] for t in jax.tree.leaves(tp)] == j_dtypes
    if dtype == "bfloat16" and arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        assert "float32" in j_dtypes     # a_log/dt_bias/D, b_r/b_i/lam
    for (path, a), (_, b), (_, b2) in zip(t_leaves, j_leaves,
                                          _leaves(jp2)):
        b, b2 = np.asarray(b, np.float32), np.asarray(b2, np.float32)
        key = jax.tree_util.keystr(path)
        assert a.shape == b.shape, key
        if np.array_equal(b, b2):        # deterministic: zeros, ones, law
            np.testing.assert_allclose(a, b, **TOL, err_msg=key)
        else:                            # dense_init: std fan_in ** -0.5
            assert abs(a.std() / b.std() - 1) < 0.1, key
    carried = params_from_numpy(_np_tree(jp))
    for t, (path, b) in zip(jax.tree.leaves(carried), j_leaves):
        assert dtypes[t.dtype] == str(b.dtype), path
        assert np.array_equal(t.float().numpy(),
                              np.asarray(b, np.float32)), path


def _list_then_stack(cfg, generator):
    """The init the stacked one replaced: R trees in a list, stacked."""
    dt = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    params = {"embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                  1, dt),
              "final_norm": torch.zeros((cfg.d_model,), dtype=dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            generator, (cfg.d_model, cfg.padded_vocab), 0, dt)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)
    params["blocks"] = [
        stack([init_block_params(cfg, kind, generator, dt)
               for _ in range(cfg.num_repeats)]) for kind in cfg.pattern]
    params["tail_blocks"] = [init_block_params(cfg, kind, generator, dt)
                             for kind in cfg.tail]
    return params


@pytest.mark.parametrize("name", ["gemma2-2b", "smollm-360m",
                                  "recurrentgemma-9b", "qwen3-moe-30b-a3b",
                                  TAIL_CASE])
def test_stacked_init_draws_what_list_then_stack_drew(name):
    arch, _ = _arch(name)
    base = get_reduced(arch)
    tail = 2 if name == TAIL_CASE else len(base.tail)
    cfg = dataclasses.replace(base, num_layers=4 * len(base.pattern) + tail)
    assert len(cfg.tail) == tail
    got = init_params(cfg, torch.Generator().manual_seed(3))
    want = _list_then_stack(cfg, torch.Generator().manual_seed(3))
    g_leaves, w_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves) > 0
    assert jax.tree.structure(_map(lambda t: 0, got)) == \
        jax.tree.structure(_map(lambda t: 0, want))
    for a, b in zip(g_leaves, w_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
